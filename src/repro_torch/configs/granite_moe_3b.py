"""granite-moe-3b-a800m — MoE 40 experts top-8, d_ff=512 per expert
[hf:ibm-granite family; the assignment bracket cites the 1b-a400m card (32e)
but the explicit config line says 40e — we follow the explicit 40e top-8]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, num_experts_per_tok=8,
)

SMOKE = CONFIG.replace(
    name="granite-moe-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=64, vocab_size=512,
    num_experts=4, num_experts_per_tok=2,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="granite-moe-3b-a800m", config=CONFIG, smoke=SMOKE,
    source="hf:ibm-granite/granite-3.0 MoE family (3b-a800m: 40e top-8)",
    long_strategy="window", long_window=4096,
    notes="40 experts do not divide the 16-way model axis; expert weights "
          "shard on the per-expert ffn dim instead (see launch/sharding.py).",
)
