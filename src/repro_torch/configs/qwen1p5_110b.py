"""qwen1.5-110b — dense GQA with QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="qwen1.5-110b", config=CONFIG, smoke=SMOKE,
    source="hf:Qwen/Qwen1.5-110B (per Qwen1.5 family card)",
    long_strategy="window", long_window=4096,
)
