"""rwkv6-1.6b — Finch: attention-free RNN, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    norm="layernorm", act="relu",
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", num_layers=2, d_model=128, num_heads=2,
    num_kv_heads=2, d_ff=256, vocab_size=512,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="rwkv6-1.6b", config=CONFIG, smoke=SMOKE,
    source="arXiv:2404.05892 (RWKV-6 'Finch')",
    long_strategy="native",
    notes="O(1) recurrent state; long_500k native (no KV cache).",
)
