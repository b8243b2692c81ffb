"""Architecture registry of the port: the language models it serves
(``ARCHS``, which the serve CLI offers), the reference registry's ten in its
order, and the paper's CNN payloads (``PAPER_MODELS``); ``get`` finds both.
``input_specs`` gives the meta-tensor inputs of every (arch x shape) step
and ``pairs`` the assignment matrix, which the dry-run
(``launch/dryrun.py``) lowers."""
from __future__ import annotations

import torch

from repro_torch.configs import (cnn_configs, deepseek_7b, granite_moe_3b,
                                 llava_next_mistral_7b, mistral_nemo_12b,
                                 qwen1p5_110b, qwen2p5_32b, qwen3_moe_235b,
                                 recurrentgemma_9b, rwkv6_1p6b, whisper_tiny)
from repro_torch.configs.base import SHAPES, ArchSpec, InputShape
from repro_torch.models import api
from repro_torch.models.common import ModelConfig

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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _modal_extras(cfg: ModelConfig, batch: int) -> dict:
    """The stubbed modality frontends' inputs: frame embeddings for audio,
    patch embeddings for vlm."""
    ex = {}
    if cfg.family == "audio":
        ex["frame_embeds"] = _meta((batch, cfg.encoder_seq, cfg.d_model), cfg.cdt)
    if cfg.family == "vlm":
        ex["patch_embeds"] = _meta((batch, cfg.num_image_tokens, cfg.d_model), cfg.cdt)
    return ex


def input_specs(arch_id: str, shape_id: str, *, smoke: bool = False,
                batch: int | None = None, seq: int | None = None):
    """-> (kind, cfg, kwargs): the inputs of the step of that shape's kind
    as meta tensors (shapes and dtypes, no memory), the counterparts of the
    reference's ``ShapeDtypeStruct`` stand-ins:
        train   -> train_step(params, opt_state, batch)    the batch
        prefill -> prefill_step(params, inputs)            the inputs
        decode  -> serve_step(params, cache, token, pos)   cache, token, pos
        predict -> a CNN's forward                         images
    The decode cache is ``api.init_cache(..., device="meta")``; ``pos`` is
    the host int ``seq - 1``, the last position of the cache (the
    reference's scalar position; the port's ``decode_step`` takes a host
    int, and a windowed cache then attends to its live band only)."""
    spec = get(arch_id)
    shp: InputShape = SHAPES[shape_id]
    cfg = spec.smoke if smoke else spec.config_for_shape(shape_id)
    b = batch if batch is not None else shp.global_batch
    s = seq if seq is not None else shp.seq_len
    if smoke and batch is None:
        b, s = 2, min(s, 16)

    if cfg.family == "cnn":
        return "predict", cfg, {"images": _meta((b, 3, cfg.image_size, cfg.image_size),
                                                torch.float32)}
    if shp.kind == "train":
        kw = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
        kw.update(_modal_extras(cfg, b))
        return "train", cfg, kw
    if shp.kind == "prefill":
        kw = {"tokens": _meta((b, s), torch.int32)}
        kw.update(_modal_extras(cfg, b))
        return "prefill", cfg, kw
    # decode: one new token against an s-long cache or state
    return "decode", cfg, {"cache": api.init_cache(cfg, b, s, device="meta"),
                           "token": _meta((b,), torch.int32), "pos": s - 1}


def pairs(include_unsupported: bool = False) -> list:
    """Every (arch_id, shape_id) of the assignment matrix."""
    return [(aid, sid) for aid, spec in ARCHS.items() for sid in SHAPES
            if include_unsupported or spec.supports(sid)]
