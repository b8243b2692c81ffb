"""qwen3-moe-235b-a22b — MoE 128 experts top-8, GQA kv=4 [hf:Qwen/Qwen3 family]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    num_experts=128, num_experts_per_tok=8, rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=64, vocab_size=512, head_dim=32,
    num_experts=4, num_experts_per_tok=2,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="qwen3-moe-235b-a22b", config=CONFIG, smoke=SMOKE,
    source="hf:Qwen/Qwen3-235B-A22B (per Qwen3-30B-A3B family card)",
    long_strategy="window", long_window=4096,
    notes="128 experts / 16-way model axis = 8 experts per shard (EP).",
)
