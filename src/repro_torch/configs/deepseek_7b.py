"""deepseek-7b — llama-arch dense, MHA (kv=32) [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
)

SMOKE = CONFIG.replace(
    name="deepseek-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=512,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="deepseek-7b", config=CONFIG, smoke=SMOKE,
    source="arXiv:2401.02954 (DeepSeek LLM 7B)",
    long_strategy="window", long_window=4096,
)
