"""ArchSpec: a registered architecture = full config + reduced smoke variant."""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    source: str                     # paper / model-card citation
    long_strategy: str = "window"   # native | window | skip
    long_window: int = 4096
    notes: str = ""

    def config_for_shape(self, shape_id: str) -> ModelConfig:
        """long_500k on full-attention archs switches to the sliding-window
        variant; everything else uses the exact config."""
        if shape_id == "long_500k" and self.long_strategy == "window":
            return self.config.replace(attention_window=self.long_window)
        return self.config

    def supports(self, shape_id: str) -> bool:
        if shape_id == "long_500k" and self.long_strategy == "skip":
            return False
        return True


@dataclasses.dataclass(frozen=True)
class InputShape:
    shape_id: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
