"""The ranks of ``tests/test_torch_distributed.py``: functions that
``repro_torch.launch.mesh.spawn`` runs in each process of a gloo group on
the CPU.  This module imports torch and the port only (no JAX: each rank
imports it anew), and each rank writes what it measured to
``<out>/<name>.rank<r>.json``, which the tests read.

Every check runs on every rank in the same order, so that the collectives
match; an exception is recorded under the check's name (with its
traceback) and the rank goes on to the next check.
"""
from __future__ import annotations

import json
import os
import traceback

import numpy as np
import torch

from repro_torch import shardctx
from repro_torch.configs import registry
from repro_torch.launch import comms, sharding, steps
from repro_torch.launch.mesh import data_axes, make_local_mesh
from repro_torch.models import api, convert, encdec, hybrid, moe, ssm, transformer, vlm
from repro_torch.models.common import ModelConfig, leaf_paths, tensor_leaves
from repro_torch.serving.engine import InferenceEngine
from repro_torch.train import checkpoint
from repro_torch.train.data import LMBatches, modal_extras
from repro_torch.train.loop import batch_on
from repro_torch.train.optimizer import AdamW

MODELS = ("deepseek-7b", "granite-moe-3b-a800m", "rwkv6-1.6b")
# the other families: vlm under tensor parallelism, hybrid and audio on the
# data axis
MORE = (("llava-next-mistral-7b", "1x2"), ("recurrentgemma-9b", "2x1"), ("whisper-tiny", "2x1"))
N_NEW = 6
# the layouts that cut heads inside or a KV sequence, by world: (arch, mesh,
# batch, attention window or 0, whether a train step runs too), the engine's
# cache LAYOUT_CACHE positions, so that a chunk holds a few of them and the
# prompt and the decode cross chunk boundaries
LAYOUTS = {
    "8": (("granite-moe-3b-a800m", "1x8", 4, 0, True),
          ("granite-moe-3b-a800m", "2x4", 1, 0, False),
          ("granite-moe-3b-a800m", "2x4", 1, 4, False)),
    "4": (("granite-moe-3b-a800m", "1x4", 4, 0, True), ("qwen3-moe-235b-a22b", "1x4", 4, 0, True),
          ("whisper-tiny", "1x4", 4, 0, True), ("deepseek-7b", "2x2", 1, 0, False),
          ("deepseek-7b", "2x2", 1, 4, False)),
    "2": (("recurrentgemma-9b", "1x2", 4, 0, True), ("whisper-tiny", "1x2", 4, 0, True),
          ("deepseek-7b", "2x1", 1, 0, False), ("deepseek-7b", "2x1", 1, 4, False),
          ("recurrentgemma-9b", "2x1", 1, 0, False), ("whisper-tiny", "2x1", 1, 0, False)),
}
LAYOUT_CACHE = 16


def _equal(a, b) -> bool:
    """Two trees of tensors equal key by key (a restored tree's dicts are in
    sorted key order)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


class Checks:
    def __init__(self, rank: int):
        self.rank, self.out = rank, {}

    def run(self, name: str, fn, *args) -> None:
        try:
            self.out[name] = fn(*args)
        except Exception as e:  # recorded for the test to report
            self.out[name] = {"error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc()}

    def write(self, path: str) -> None:
        with open(f"{path}.rank{self.rank}.json", "w") as f:
            json.dump(self.out, f)


def _rows(mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` rows (``batch_pspec``)."""
    spec = sharding.batch_pspec((batch,), mesh)
    if spec[0] is None:
        return slice(0, batch)
    n = mesh.size(spec[0])
    i = mesh.index(spec[0])
    return slice(i * batch // n, (i + 1) * batch // n)


def _prompts(cfg: ModelConfig, b: int = 4, s: int = 8) -> torch.Tensor:
    """Seeded prompts; a vlm's hold its image tokens' positions first (the
    patch embeddings take their place), then ``s`` text tokens."""
    if cfg.family == "vlm":
        s += cfg.num_image_tokens
    return torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)))


def _patches(cfg: ModelConfig, b: int = 4) -> torch.Tensor:
    """Seeded N(0, 1) patch embeddings of a vlm's prompts, float32."""
    return torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))


def _single_logits(params, cfg, tokens, rows: slice = slice(None)):
    """The family's forward over ``tokens`` (B,S) -> logits (B,S,V); the
    audio family over the engine's zero frame embeddings, the vlm over
    ``_patches``' ``rows``."""
    b = tokens.shape[0]
    if cfg.family == "ssm":
        return ssm.forward(params, tokens, cfg)[0]
    if cfg.family == "hybrid":
        return hybrid.forward(params, tokens, cfg)[0]
    if cfg.family == "audio":
        frames = torch.zeros((b, cfg.encoder_seq, cfg.d_model), dtype=cfg.cdt)
        return encdec.forward(params, {"tokens": tokens, "frame_embeds": frames}, cfg)[0]
    if cfg.family == "vlm":
        patches = _patches(cfg)[rows].to(cfg.cdt)
        return vlm.forward(params, {"tokens": tokens, "patch_embeds": patches}, cfg)[0]
    return transformer.forward(params, tokens, cfg)[0]


def models_check(mesh, arch: str) -> dict:
    """Sharded logits and greedy engine tokens of ``arch``'s smoke config
    against the single-device path on the same seeded weights.  A MoE
    routes each data rank's rows in its own groups, as the reference's
    shard_map does: its single-device oracle runs each rank's rows apart."""
    cfg = registry.get(arch).smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _prompts(cfg)
    rows = _rows(mesh, tokens.shape[0])
    per_shard = cfg.is_moe and rows != slice(0, tokens.shape[0])
    want = _single_logits(params, cfg, tokens[rows] if per_shard else tokens,
                          rows if per_shard else slice(None))[
        slice(None) if per_shard else rows]
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    local = sharding.shard_tree(params, pspecs, mesh)
    with shardctx.use_mesh(mesh):
        got = _single_logits(local, cfg, tokens[rows], rows)
    out = {"logits_rel": _rel(got, want), "logits_max_abs": float((got - want).abs().max()),
           "last": got[:, -1].tolist(), "rows": [rows.start, rows.stop], "per_shard": per_shard}
    if cfg.family == "ssm":
        with shardctx.use_mesh(mesh):
            out["wkv_heads"] = int(local["layers"][0]["tmix"]["u"].shape[0])
    eng = InferenceEngine(cfg, seed=0, device="cpu", mesh=mesh)
    toks = eng.generate(tokens, N_NEW).tokens
    if per_shard:
        n = mesh.size(data_axes(mesh))
        ref = torch.cat([InferenceEngine(cfg, seed=0, device="cpu").generate(part, N_NEW).tokens
                         for part in tokens.chunk(n)])
    else:
        ref = InferenceEngine(cfg, seed=0, device="cpu").generate(tokens, N_NEW).tokens
    stream = eng.generate_stream(tokens, N_NEW).tokens
    out.update(tokens=toks.tolist(), want=ref.tolist(), stream=stream.tolist())
    return out


def layout_name(arch: str, mesh: str, batch: int, window: int) -> str:
    return f"layout {arch} {mesh} b{batch}" + (f" w{window}" if window else "")


def _smoke(arch: str, window: int = 0) -> ModelConfig:
    cfg = registry.get(arch).smoke
    return cfg.replace(attention_window=window) if window else cfg


def _engine_logits(eng, tokens, steps: list) -> list:
    """The engine's uncaptured prefill of ``tokens`` (exact length), then
    one decode step for each token of ``steps`` (teacher-forced, from
    position S on): every step's logits, float32, the rows of every rank
    gathered on a mesh engine."""
    b, s = tokens.shape
    out = []
    with eng._on_mesh(b):
        local = eng._local_rows(tokens)
        logits, cache = eng._prefill(local, None, eng.max_cache)
        out.append(eng._all_rows(logits.float().clone(), 0))
        for i, tok in enumerate(steps):
            tok = eng._local_rows(tok[:, None])[:, 0]
            logits, _ = api.decode_step(eng.params, cache, tok, s + i, eng.cfg)
            out.append(eng._all_rows(logits.float(), 0))
    return out


def layout_check(mesh, arch: str, batch: int, window: int) -> dict:
    """A layout that cuts heads inside or a KV sequence: ``arch``'s smoke
    config (with ``window``) through the mesh engine on a
    ``LAYOUT_CACHE``-position cache against the single device on the same
    seeded weights: the prefill's and each teacher-forced decode step's
    logits, the greedy tokens of ``generate`` and ``generate_stream``, the
    cache's sequence cuts, and one decode step's collectives."""
    cfg = _smoke(arch, window)
    tokens = _prompts(cfg, batch)
    single = InferenceEngine(cfg, seed=0, device="cpu", max_cache=LAYOUT_CACHE)
    want = single.generate(tokens, N_NEW).tokens
    steps = list(want.T[:N_NEW - 1])
    want_logits = _engine_logits(single, tokens, steps)
    eng = InferenceEngine(cfg, seed=0, device="cpu", mesh=mesh, max_cache=LAYOUT_CACHE)
    got_logits = _engine_logits(eng, tokens, steps)
    rels = [_rel(g, w) for g, w in zip(got_logits, want_logits)]
    toks = eng.generate(tokens, N_NEW).tokens
    stream = eng.generate_stream(tokens, N_NEW).tokens
    with eng._on_mesh(batch):
        cuts = {k: list(v) for k, v in shardctx.get_seq_cuts().items()}
        shardctx.reset_counts()
        tok = eng._local_rows(want[:, -1:])[:, 0]
        api.decode_step(eng.params, eng._cache, tok, tokens.shape[1] + N_NEW - 1, cfg)
        counts = shardctx.counts()
    return {"prefill_rel": rels[0], "decode_rel": max(rels[1:]),
            "last": got_logits[0].tolist(), "tokens": toks.tolist(), "want": want.tolist(),
            "stream": stream.tolist(), "seq_cuts": cuts, "counts": counts,
            "plan": comms.decode_step(cfg, mesh.shape, batch=batch, cache_len=LAYOUT_CACHE,
                                      model_index=mesh.coords["model"])}


def moe_case(mesh, path: str) -> dict:
    """The reference's MoE case in ``path`` (its weights and input, numpy)
    through the port's layer on this mesh: the whole output (the data ranks'
    rows gathered) and the data ranks' mean load-balance loss."""
    z = np.load(path)
    cfg = ModelConfig(name="m", family="moe", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=16, vocab_size=64,
                      num_experts=int(z["num_experts"]), num_experts_per_tok=2,
                      moe_capacity_factor=2.0, param_dtype="float32",
                      compute_dtype="float32")
    p = {"router": {"w": torch.from_numpy(z["router"])},
         **{k: torch.from_numpy(z[k]) for k in ("wi", "wu", "wd")}}
    specs = sharding.param_pspecs({"moe": p}, cfg, mesh)
    local = sharding.shard_tree({"moe": p}, specs, mesh)["moe"]
    x = torch.from_numpy(z["x"])
    dax = data_axes(mesh)
    with shardctx.use_mesh(mesh):
        y, aux = moe.moe_apply(local, x[_rows(mesh, x.shape[0])], cfg)
        y = shardctx.all_gather(y, dax, 0) if y.shape[0] < x.shape[0] else y
        aux = shardctx.all_reduce(aux, dax) / mesh.size(dax)
    ep = local["wi"].shape[0] < cfg.num_experts
    return {"y": y.numpy().tolist(), "aux": float(aux), "ep": ep,
            "wi_local": list(local["wi"].shape)}


def decode_counts(mesh, arch: str = "deepseek-7b", batch: int = 2) -> dict:
    """One decode step's collectives on this rank: counted kinds, counts
    and bytes per rank."""
    cfg = registry.get(arch).smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    local = sharding.shard_tree(params, pspecs, mesh)
    abs_cache = api.init_cache(cfg, batch, 32, device="meta")
    cache = sharding.local_zeros(
        abs_cache, sharding.cache_pspecs(abs_cache, cfg, mesh, batch=batch), mesh)
    tokens = _prompts(cfg, batch, 8)[_rows(mesh, batch)]
    with shardctx.use_mesh(mesh):
        api.prefill(local, {"tokens": tokens}, cfg, 32, cache=cache)
        shardctx.reset_counts()
        logits, _ = api.decode_step(local, cache, tokens[:, -1], 8, cfg)
        counts = shardctx.counts()
    return {"counts": counts, "batch": int(tokens.shape[0]), "vocab": list(logits.shape)}


def serving_steps_check(mesh, arch: str, layout: str) -> dict:
    """``launch/steps.py``'s prefill and decode steps on a mesh, ``layout``
    "fsdp" (every weight cut over "data" too, gathered by the step) or
    "replicated" (no weight cut, the cache whole over "model": the
    dry-run's small-model prefill): this rank's last logits of a (4, 8)
    prefill and of one decode step at position 8 of a 16-position cache,
    against the single device's rows on the same seeded weights, and the
    collectives each step ran."""
    cfg = registry.get(arch).smoke
    params = _params(cfg)
    tokens = _prompts(cfg)
    b, s = tokens.shape
    rows = _rows(mesh, b)
    abstract = api.abstract_params(cfg)
    specs = (sharding.replicated_pspecs(abstract) if layout == "replicated"
             else sharding.param_pspecs(abstract, cfg, mesh, fsdp=True))
    use_model = layout != "replicated"
    local = sharding.shard_tree(params, specs, mesh)
    whole = api.init_cache(cfg, b, 16, device="cpu")
    want_prefill, _ = api.prefill(params, {"tokens": tokens}, cfg, 16, cache=whole)
    want_decode, _ = api.decode_step(params, whole, tokens[:, -1], s, cfg)
    out = {"rows": [rows.start, rows.stop]}
    for name, length in (("prefill", s), ("decode", 16)):
        abs_cache = api.init_cache(cfg, b, length, device="meta")
        cache_sp = sharding.cache_pspecs(abs_cache, cfg, mesh, batch=b, use_model=use_model)
        shardctx.reset_counts()
        if name == "prefill":
            step = steps.make_prefill_step(cfg, mesh=mesh, param_pspecs=specs,
                                           cache_pspecs=cache_sp)
            cache = sharding.local_zeros(abs_cache, cache_sp, mesh)
            got, _ = step(local, {"tokens": tokens[rows]}, cache)
            want = want_prefill[rows]
        else:
            # the single device's cache after its prefill, this rank's shard of it
            step = steps.make_serve_step(cfg, mesh=mesh, param_pspecs=specs,
                                         cache_pspecs=cache_sp)
            single = api.init_cache(cfg, b, 16, device="cpu")
            api.prefill(params, {"tokens": tokens}, cfg, 16, cache=single)
            cache = sharding.shard_tree(single, cache_sp, mesh)
            got, _ = step(local, cache, tokens[rows, -1], s)
            want = want_decode[rows]
        out[name] = {"rel": _rel(got, want), "counts": shardctx.counts(),
                     "cut": sum(1 for sp in sharding.spec_leaves(specs)
                                if sharding.fsdp_cuts(sp, mesh))}
    return out


def _params(cfg):
    p = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "ssm":
        gen = torch.Generator().manual_seed(6)
        for lp in p["layers"]:
            lp["tmix"]["wo"]["w"] = torch.randn((cfg.d_model, cfg.d_model), generator=gen) \
                * cfg.d_model ** -0.5
    return p


def train_check(mesh, fsdp: bool, num_micro: int, arch: str = "deepseek-7b",
                window: int = 0) -> dict:
    """One AdamW step of ``arch``'s smoke config (float32) on this mesh
    against the single-device step: loss, grad norm, and the params after
    it (gathered).  rwkv's ``tmix.wo`` is redrawn (its init 0 cuts the WKV
    branch out of the gradient).  A MoE under a data axis routes each
    rank's rows in groups of its own: its single-device oracle takes the
    ranks' rows as microbatches (``num_micro`` times the data ranks), whose
    gradients it averages as the data ranks' are averaged; its load-balance
    loss is then weighted 0, since the microbatches' loss counts each one's
    own experts while the data ranks' counts the whole batch's, as the
    reference's (``moe_case`` holds that loss)."""
    cfg = _smoke(arch, window)
    if cfg.is_moe and mesh.size(data_axes(mesh)) > 1:
        cfg = cfg.replace(router_aux_weight=0.0)
    batch = batch_on({**LMBatches(cfg.vocab_size, 4, 16, seed=0)(0), **modal_extras(cfg, 4)},
                     cfg, "cpu")
    opt = AdamW(learning_rate=1e-3)
    params = _params(cfg)
    tree = _params(cfg)
    micro = num_micro * (mesh.size(data_axes(mesh)) if cfg.is_moe else 1)
    _, _, want = steps.make_train_step(cfg, opt, num_micro=micro)(tree, opt.init(tree), batch)
    want_params = list(tensor_leaves(tree))
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh, fsdp=fsdp)
    local = sharding.shard_tree(params, pspecs, mesh)
    state = opt.init(local)
    step = steps.make_train_step(cfg, opt, num_micro=num_micro, mesh=mesh, param_pspecs=pspecs)
    shardctx.reset_counts()
    _, state, got = step(local, state, sharding.shard_batch(batch, mesh))
    counts = shardctx.counts()
    whole = sharding.gather_tree(local, pspecs, mesh)
    # a key projection's bias has a zero gradient in exact arithmetic (it
    # shifts all of a query's logits alike), so its computed gradient is
    # rounding noise that AdamW's first step scales up to +-lr either way:
    # those leaves are left out of the comparison and counted
    key_bias = [keys[-2:] == ("wk", "b") for keys in leaf_paths(tree)]
    rels = [_rel(a.detach(), b.detach()) for a, b, skip in
            zip(tensor_leaves(whole), want_params, key_bias) if not skip]
    moments = sum(t.numel() for t in state["mu"])
    return {"loss": float(got["loss"]), "want_loss": float(want["loss"]),
            "gnorm": float(got["grad_norm"]), "want_gnorm": float(want["grad_norm"]),
            "param_rel": max(rels), "key_bias_leaves": sum(key_bias), "counts": counts,
            "local_moments": moments, "params": sum(t.numel() for t in want_params)}


def refusals(mesh) -> dict:
    """The layouts that the port refused before it cut heads inside and KV
    sequences: each entry point now builds them ("accepted"), else the
    error."""
    out = {}
    cases = [("recurrentgemma-9b", "engine"), ("whisper-tiny", "engine"),
             ("recurrentgemma-9b", "train"), ("whisper-tiny", "train")]
    if mesh.shape["model"] > registry.get("granite-moe-3b-a800m").smoke.num_kv_heads:
        cases.append(("granite-moe-3b-a800m", "engine"))
    for arch, entry in cases:
        cfg = registry.get(arch).smoke
        try:
            if entry == "engine":
                InferenceEngine(cfg, seed=0, device="cpu", mesh=mesh)
            else:
                steps.make_train_step(cfg, AdamW(), mesh=mesh)
            out[f"{arch} {entry}"] = "accepted"
        except Exception as e:  # recorded for the test to report
            out[f"{arch} {entry}"] = f"{type(e).__name__}: {e}"
    return out


def checkpoint_save(mesh, path: str) -> dict:
    """deepseek's smoke params cut at this mesh (FSDP specs) and saved in
    the reference's layout."""
    cfg = registry.get("deepseek-7b").smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh, fsdp=True)
    local = sharding.shard_tree(params, pspecs, mesh)
    checkpoint.save(path, {"params": convert.to_reference(local, cfg)}, step=3, mesh=mesh,
                    pspecs={"params": convert.to_reference(pspecs, cfg)})
    return {"saved": os.path.exists(path + ".npz")}


def checkpoint_restore(mesh, path: str) -> dict:
    """The checkpoint restored into this mesh's shards, gathered again, and
    restored on a single device: each against the seeded params."""
    cfg = registry.get("deepseek-7b").smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    like = {"params": convert.to_reference(params, cfg)}
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    local, step, _ = checkpoint.restore(path, like, mesh=mesh,
                                        pspecs={"params": convert.to_reference(pspecs, cfg)})
    local = convert.from_reference(local["params"], cfg, "cpu")
    whole = sharding.gather_tree(local, pspecs, mesh)
    single, _, _ = checkpoint.restore(path, like)
    single = convert.from_reference(single["params"], cfg, "cpu")
    return {"step": step,
            "cut": local["embed"]["embedding"].shape[0] < cfg.vocab_size,
            "mesh_equal": _equal(whole, params), "single_equal": _equal(single, params)}


def layouts(c: Checks, world: str, meshes: dict) -> None:
    """The ``LAYOUTS`` cells of ``world`` on their meshes, and a TP train
    step where the cell asks for one."""
    for arch, mesh, batch, window, train in LAYOUTS[world]:
        name = layout_name(arch, mesh, batch, window)
        c.run(name, layout_check, meshes[mesh], arch, batch, window)
        if train:
            c.run(f"train {name}", train_check, meshes[mesh], False, 1, arch, window)


def checkpoint_roundtrip(mesh, arch: str, path: str) -> dict:
    """``arch``'s smoke params cut at this mesh, saved in the reference's
    layout, restored into this mesh's shards and on a single device: each
    against the seeded params (the checkpoint of a layout that cuts heads
    inside, the hybrid's recurrence or whisper's vocabulary); the restored
    shards as a mesh engine's ``shards``, whose tokens must equal those of
    the engine that cuts the whole params, and the whole params as
    ``shards``, which the engine must refuse."""
    cfg = registry.get(arch).smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    ref_specs = {"params": convert.to_reference(pspecs, cfg)}
    local = sharding.shard_tree(params, pspecs, mesh)
    checkpoint.save(path, {"params": convert.to_reference(local, cfg)}, step=2, mesh=mesh,
                    pspecs=ref_specs)
    like = {"params": convert.to_reference(params, cfg)}
    back, step, _ = checkpoint.restore(path, like, mesh=mesh, pspecs=ref_specs)
    back = convert.from_reference(back["params"], cfg, "cpu")
    single, _, _ = checkpoint.restore(path, like)
    single = convert.from_reference(single["params"], cfg, "cpu")
    tokens = _prompts(cfg)
    want = InferenceEngine(cfg, params=params, device="cpu", mesh=mesh,
                           max_cache=LAYOUT_CACHE).generate(tokens, N_NEW).tokens
    got = InferenceEngine(cfg, shards=back, device="cpu", mesh=mesh,
                          max_cache=LAYOUT_CACHE).generate(tokens, N_NEW).tokens
    try:
        InferenceEngine(cfg, shards=params, device="cpu", mesh=mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"step": step, "shards_equal": _equal(back, local),
            "mesh_equal": _equal(sharding.gather_tree(back, pspecs, mesh), params),
            "single_equal": _equal(single, params), "engine_tokens_equal": _equal(got, want),
            "whole_refused": refused.startswith("shard ")}


def world8(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    c = Checks(rank)
    layouts(c, "8", {"1x8": make_local_mesh(1, 8, device="cpu"),
                     "2x4": make_local_mesh(2, 4, device="cpu")})
    c.write(out)


def world4(rank: int, out: str, moe_dir: str, ckpt: str) -> None:
    torch.set_num_threads(1)
    c = Checks(rank)
    mesh = make_local_mesh(2, 2, device="cpu")
    for case in ("ep", "tpf"):
        c.run(f"moe {case} 2x2", moe_case, mesh, os.path.join(moe_dir, f"{case}.npz"))
    for arch in MODELS:
        c.run(f"{arch} 2x2", models_check, mesh, arch)
    c.run("refusals 2x2", refusals, mesh)
    for arch in ("deepseek-7b", "rwkv6-1.6b"):
        for layout in ("fsdp", "replicated"):
            c.run(f"serving {layout} {arch} 2x2", serving_steps_check, mesh, arch, layout)
    c.run("checkpoint save 2x2", checkpoint_save, mesh, ckpt)
    tp = make_local_mesh(1, 4, device="cpu")
    c.run("decode counts 1x4", decode_counts, tp)
    c.run("refusals 1x4", refusals, tp)
    layouts(c, "4", {"2x2": mesh, "1x4": tp})
    c.run("checkpoint whisper-tiny 1x4", checkpoint_roundtrip, tp, "whisper-tiny",
          ckpt + "-whisper")
    c.write(out)


def world2(rank: int, out: str, ckpt: str) -> None:
    torch.set_num_threads(2)
    c = Checks(rank)
    tp, dp = make_local_mesh(1, 2, device="cpu"), make_local_mesh(2, 1, device="cpu")
    meshes = {"1x2": tp, "2x1": dp}
    for name, mesh in meshes.items():
        for arch in MODELS:
            c.run(f"{arch} {name}", models_check, mesh, arch)
    for arch, name in MORE:
        c.run(f"{arch} {name}", models_check, meshes[name], arch)
    c.run("decode counts 1x2", decode_counts, tp)
    c.run("train dp 2x1", train_check, dp, False, 1)
    c.run("train fsdp micro2 2x1", train_check, dp, True, 2)
    c.run("train tp 1x2", train_check, tp, False, 1)
    c.run("train tp rwkv 1x2", train_check, tp, False, 1, "rwkv6-1.6b")
    c.run("train tp granite 1x2", train_check, tp, False, 1, "granite-moe-3b-a800m")
    c.run("train dp granite 2x1", train_check, dp, False, 1, "granite-moe-3b-a800m")
    c.run("checkpoint restore 1x2", checkpoint_restore, tp, ckpt)
    layouts(c, "2", meshes)
    c.run("checkpoint recurrentgemma-9b 1x2", checkpoint_roundtrip, tp, "recurrentgemma-9b",
          ckpt + "-hybrid")
    c.write(out)
