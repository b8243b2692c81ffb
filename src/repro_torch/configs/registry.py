"""Architecture registry of the port: the language models it serves
(``ARCHS``, which the serve CLI offers), the reference registry's ten in its
order, and the paper's CNN payloads (``PAPER_MODELS``); ``get`` finds both."""
from __future__ import annotations

from repro_torch.configs import (cnn_configs, deepseek_7b, granite_moe_3b,
                                 llava_next_mistral_7b, mistral_nemo_12b,
                                 qwen1p5_110b, qwen2p5_32b, qwen3_moe_235b,
                                 recurrentgemma_9b, rwkv6_1p6b, whisper_tiny)
from repro_torch.configs.base import ArchSpec

ARCHS: dict[str, ArchSpec] = {
    s.arch_id: s
    for s in (
        rwkv6_1p6b.SPEC,
        recurrentgemma_9b.SPEC,
        whisper_tiny.SPEC,
        llava_next_mistral_7b.SPEC,
        deepseek_7b.SPEC,
        granite_moe_3b.SPEC,
        qwen2p5_32b.SPEC,
        qwen3_moe_235b.SPEC,
        qwen1p5_110b.SPEC,
        mistral_nemo_12b.SPEC,
    )
}

# the paper's own serving payloads
PAPER_MODELS: dict[str, ArchSpec] = {
    s.arch_id: s for s in
    (cnn_configs.SQUEEZENET, cnn_configs.RESNET18, cnn_configs.RESNEXT50)
}

ALL: dict[str, ArchSpec] = {**ARCHS, **PAPER_MODELS}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in ALL:
        raise KeyError(f"unknown architecture {arch_id!r}; the port serves "
                       f"{sorted(ALL)}")
    return ALL[arch_id]
