"""whisper-tiny — enc-dec audio backbone, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, encoder_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, encoder_seq=1500,
    qkv_bias=True, norm="layernorm", act="gelu", tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", num_layers=2, encoder_layers=2, d_model=96,
    num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=512, encoder_seq=16,
    param_dtype="float32", compute_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="whisper-tiny", config=CONFIG, smoke=SMOKE,
    source="arXiv:2212.04356 (Whisper)",
    long_strategy="skip",
    notes="Mel+conv frontend is a stub: input_specs provides (B,1500,384) "
          "frame embeddings. long_500k skipped (full-attn enc-dec; see DESIGN.md).",
)
