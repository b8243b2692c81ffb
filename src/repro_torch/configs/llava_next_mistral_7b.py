"""llava-next-mistral-7b — anyres VLM [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    num_image_tokens=2880,  # anyres: base 576 + 2x2 grid tiles
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="llava-smoke", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, d_ff=256, vocab_size=512, num_image_tokens=8,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="llava-next-mistral-7b", config=CONFIG, smoke=SMOKE,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (LLaVA-NeXT, anyres)",
    long_strategy="window", long_window=4096,
    notes="ViT/projector stubbed: input_specs provides (B,2880,4096) patch "
          "embeddings merged into the token stream.",
)
