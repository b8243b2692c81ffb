"""recurrentgemma-9b — RG-LRU + local attention, 1:2 pattern [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,  # MQA (kv=1)
    d_ff=12288, vocab_size=256000,
    pattern=("rglru", "rglru", "attn"), attention_window=2048,
    rglru_conv_width=4, norm="rmsnorm", act="gelu",
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", num_layers=3, d_model=128, num_heads=2,
    num_kv_heads=1, d_ff=256, vocab_size=512, attention_window=8,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="recurrentgemma-9b", config=CONFIG, smoke=SMOKE,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    long_strategy="native",
    notes="38 = 12x(rglru,rglru,attn) + 2 extra rglru layers; window-2048 "
          "ring-buffer KV => state O(window), long_500k native.",
)
