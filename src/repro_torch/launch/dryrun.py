"""The dry-run: every (arch x shape) step of the registry as one rank's step
on meta tensors, on the reference's production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--multi-pod] [--rank R] [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The port's counterpart of ``repro/launch/dryrun.py``.  The reference lowers
and compiles each step for 256 or 512 host placeholder devices and reads
the compiled module.  The port has no compiler between the step and the
card, so it runs the step: one rank of the (16, 16) or (2, 16, 16) mesh
(``make_production_mesh``), its params, moments, cache and rows the local
shards that the partition rules give that rank (``sharding.local_shape``),
every tensor on the meta device (shapes and dtypes, no memory, no value),
inside a ``fake`` process group of the mesh's world (torch's
``torch.testing._internal.distributed.fake_pg``: its collectives return at
once and move nothing).  Meta tensors are the dry-run's only device, as
host placeholders are the reference's.  The step is the port's own
(``launch/steps.py``), through the model code and the kernels' meta routes
(``kernels/dispatch.py``), so what it counts is what the port runs:

* the collectives, by kind, count and a rank's ring bytes, from
  ``shardctx.counts()``;
* the FLOPs and HBM bytes, and the memory of the step, from
  ``analysis/count.py`` (aten ops plus the kernels' own counts);
* the roofline terms against one H100 (``analysis/roofline.py``).

No step computes a value, so the dry-run needs no card and runs wherever
torch does.  ``lower_s`` is the step's wall time here; ``compile_s`` is
0.0: nothing is compiled (the kernels' meta routes build nothing).
``loop_trips`` is the reference's and is only recorded: the port runs every
layer and every microbatch, so every collective is counted as it runs.

Each run writes ``<out>/<arch>__<shape>__<single|multi>[_int8].json``,
which ``analysis/report.py`` reads.  The reference's sequence parallelism
(``--seq-parallel``) is not ported: asking for it exits with a message.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import shardctx
from repro_torch.analysis import count
from repro_torch.analysis.roofline import roofline_terms
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding
from repro_torch.launch.mesh import axis_size, data_axes, make_production_mesh, model_axis
from repro_torch.launch.steps import (choose_microbatch, make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import api
from repro_torch.train.optimizer import AdamW

SEQ_PARALLEL = ("--seq-parallel: the reference's sequence parallelism between blocks "
                "(src/repro/shardctx.py:60-80, the sequence of the activations sharded "
                "over 'model') is not ported; the port's shardctx.constrain_batch is the "
                "identity")


def production_world(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """The default process group for a dry-run of ``world`` ranks, as rank
    ``rank``: a ``fake`` group made here and destroyed on exit, or the
    group that exists, which must hold ``world`` ranks (it is not
    replaced)."""
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world:
            raise RuntimeError(f"a process group of {have} ranks exists; this dry-run "
                               f"needs {world}")
        yield
        return
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not one of the {world} ranks")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def loop_trips(cfg, kind: str, seq_len: int, num_micro: int = 1) -> tuple:
    """The reference's structurally known scan trip counts (outermost
    first), recorded for comparison only: the reference weights the
    collectives and dots inside its HLO loop bodies by them, the port runs
    every trip and counts it as it runs."""
    if cfg.family == "hybrid":
        layers = max(cfg.num_layers // max(len(cfg.pattern), 1), 1)
    else:
        layers = max(cfg.num_layers, 1)
    if kind == "decode":
        inner = 1
    elif cfg.family == "ssm":
        inner = seq_len            # time scan
    elif seq_len > 2048:
        inner = seq_len // 1024    # chunked-attention scan
    else:
        inner = 1
    if cfg.family == "ssm" and kind == "prefill" and seq_len > 8192:
        return (seq_len // 8192, layers, 8192)
    if kind == "train" and num_micro > 1:
        return (num_micro, layers, inner)
    return (layers, inner)


@dataclasses.dataclass
class Lowered:
    """One rank's step and its arguments, all on the meta device; what the
    reference's ``jit(...).lower(...)`` stands for."""
    step: object
    args: tuple
    int8_ratio: float | None = None   # the quantized weights' bytes over bf16's


def _dequantizer(qspecs, mesh, dtype):
    """-> (the function that turns the rank's shards of a quantized tree,
    cut by ``qspecs``, into its dequantized weights, the spec tree of those
    weights).  FSDP's cuts of ``q`` and ``scale`` are gathered first (the
    scale is cut on its own dims); then a scale is sliced as its ``q`` is
    cut over "model" on the dims where it is not 1 (a column-cut ``q``
    takes its columns' scales).  The weights are then cut over "model"
    alone, as the rules cut them."""
    def deq_specs(specs):
        if isinstance(specs, dict):
            if set(specs) == {"q", "scale"}:
                return model_only(specs["q"])
            return {k: deq_specs(v) for k, v in specs.items()}
        if isinstance(specs, list):
            return [deq_specs(v) for v in specs]
        return None if specs is None else model_only(specs)

    def model_only(spec):
        cut = dict(sharding.fsdp_cuts(spec, mesh))
        return tuple(None if i in cut else e for i, e in enumerate(spec))

    def deq(tree, specs):
        if isinstance(tree, dict):
            if set(tree) == {"q", "scale"}:
                q = sharding.gather_fsdp(tree["q"], sharding.fsdp_cuts(specs["q"], mesh))
                scale = sharding.gather_fsdp(tree["scale"],
                                             sharding.fsdp_cuts(specs["scale"], mesh))
                for dim, axes in sharding.spec_cuts(model_only(specs["q"])):
                    if scale.shape[dim] > 1:
                        scale = shardctx.local_slice(scale, axes, dim)
                return (q.float() * scale).to(dtype)
            return {k: deq(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [deq(v, s) for v, s in zip(tree, specs)]
        if isinstance(tree, torch.Tensor):
            return sharding.gather_fsdp(tree, sharding.fsdp_cuts(specs, mesh))
        return tree

    return (lambda params: deq(params, qspecs)), deq_specs(qspecs)


def lower_pair(arch_id: str, shape_id: str, *, multi_pod: bool, mesh=None,
               int8: bool = False, batch: int | None = None, seq: int | None = None):
    """Build one pair's step on ``mesh`` (default: the production mesh over
    the existing process group) with the rank's local meta tensors.  ->
    (``Lowered``, meta, cfg).  The reference's lowering rules:

    * FSDP (weights and moments also cut over "data") for a train step, or
      where the weights over the model axis pass 4 GB a rank: the
      reference's rule for its 16 GB chips, kept as it is, not resized for
      an 80 GB card;
    * replicated weights for a small (under 4 GB) non-MoE prefill: pure data
      parallelism, the cache replicated over "model" too
      (``cache_pspecs(use_model=False)``);
    * ``choose_microbatch`` for a train step's microbatches, ``opt_pspecs``
      for its moments;
    * ``int8``: a prefill's or decode step's weights quantized
      (``serving/quantize.py``) and dequantized inside the step.

    ``batch`` and ``seq`` replace the shape's global batch and length
    (``registry.input_specs``)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    kind, cfg, kw = registry.input_specs(arch_id, shape_id, batch=batch, seq=seq)
    abs_params = api.abstract_params(cfg)
    dp = axis_size(mesh, data_axes(mesh))
    msz = axis_size(mesh, model_axis(mesh))
    param_gb = cfg.param_count() * 2 / max(msz, 1) / 1e9
    fsdp = kind == "train" or param_gb > 4.0
    replicate = kind == "prefill" and not cfg.is_moe and cfg.param_count() * 2 / 1e9 < 4.0
    quant = int8 and kind in ("prefill", "decode")
    dequant = None
    if quant:
        from repro_torch.serving import quantize as qz
        abs_params, qstats = qz.quantize_params(abs_params)
    pspecs = (sharding.replicated_pspecs(abs_params) if replicate
              else sharding.param_pspecs(abs_params, cfg, mesh, fsdp=fsdp))
    params = sharding.local_zeros(abs_params, pspecs, mesh)
    step_specs = pspecs
    if quant:
        dequant, step_specs = _dequantizer(pspecs, mesh, cfg.cdt)
    meta = {"arch": arch_id, "shape": shape_id, "kind": kind,
            "mesh": [mesh.shape[a] for a in mesh.axis_names], "axes": list(mesh.axis_names),
            "n_devices": int(axis_size(mesh, mesh.axis_names)), "fsdp": fsdp, "int8": int8,
            "replicated_weights": replicate}
    ratio = qstats["ratio"] if quant else None

    def wrap(step):
        if dequant is None:
            return step
        return lambda params, *a: step(dequant(params), *a)

    if kind == "train":
        opt = AdamW()
        abs_opt = opt.init(abs_params)
        opt_state = sharding.local_zeros(abs_opt, sharding.opt_pspecs(abs_opt, pspecs), mesh)
        rows = sharding.local_zeros(kw, sharding.input_pspecs(kw, mesh), mesh)
        b, s = kw["tokens"].shape
        num_micro = choose_microbatch(cfg, b, s, dp)
        meta["num_micro"] = num_micro
        step = make_train_step(cfg, opt, num_micro=num_micro, mesh=mesh, param_pspecs=pspecs)
        return Lowered(step, (params, opt_state, rows)), meta, cfg
    if kind == "prefill":
        inputs = sharding.local_zeros(kw, sharding.input_pspecs(kw, mesh), mesh)
        b, s = kw["tokens"].shape
        whole = api.init_cache(cfg, b, s, device="meta")
        cache_sp = sharding.cache_pspecs(whole, cfg, mesh, batch=b, use_model=not replicate)
        cache = sharding.local_zeros(whole, cache_sp, mesh)
        step = make_prefill_step(cfg, mesh=mesh, param_pspecs=step_specs,
                                 cache_pspecs=cache_sp)
        return Lowered(wrap(step), (params, inputs, cache), ratio), meta, cfg
    if kind == "decode":
        b = kw["token"].shape[0]
        cache_sp = sharding.cache_pspecs(kw["cache"], cfg, mesh, batch=b,
                                         use_model=not replicate)
        cache = sharding.local_zeros(kw["cache"], cache_sp, mesh)
        token = sharding.local_zeros(kw["token"], sharding.batch_pspec((b,), mesh), mesh)
        step = make_serve_step(cfg, mesh=mesh, param_pspecs=step_specs, cache_pspecs=cache_sp)
        return Lowered(wrap(step), (params, cache, token, kw["pos"]), ratio), meta, cfg
    # a CNN's forward, its images cut over the data axes
    from repro_torch.models import cnn
    images = sharding.local_zeros(kw["images"], sharding.batch_pspec(
        tuple(kw["images"].shape), mesh), mesh)
    return Lowered(lambda p, x: cnn.predict(p, x, cfg), (params, images)), meta, cfg


def _mem_stats(counted: dict) -> dict:
    """The counterparts of XLA's ``memory_analysis`` keys: the output holds
    the aliased arguments too, as XLA's does."""
    out = {"argument_size_in_bytes": int(counted["argument_bytes"]),
           "output_size_in_bytes": int(counted["output_bytes"] + counted["alias_bytes"]),
           "temp_size_in_bytes": int(counted["temp_bytes"]),
           "alias_size_in_bytes": int(counted["alias_bytes"]),
           "generated_code_size_in_bytes": 0}
    out["total_bytes_per_device"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out


def _collectives(counts: dict) -> dict:
    """{kind: a rank's ring bytes, "total", "counts": {kind: collectives}},
    the reference's ``collective_bytes`` layout."""
    out = {k: b for k, (_, b) in counts.items()}
    out["total"] = sum(out.values())
    out["counts"] = {k: n for k, (n, _) in counts.items()}
    return out


@contextlib.contextmanager
def _production(mesh, multi_pod: bool, rank: int):
    """``mesh``, or the production mesh over a fake group made for it."""
    if mesh is not None:
        yield mesh
        return
    with fake_group(production_world(multi_pod), rank):
        yield make_production_mesh(multi_pod=multi_pod)


def run_pair(arch_id: str, shape_id: str, *, multi_pod: bool, out_dir: str,
             verbose: bool = True, mesh=None, seq_parallel: bool = False,
             int8: bool = False, rank: int = 0, batch: int | None = None,
             seq: int | None = None) -> dict:
    """Run one pair's step once as one rank and record it (written to
    ``out_dir`` unless it is empty).  Without ``mesh``, the production mesh
    over a fake group of its world made here (as rank ``rank``) and
    destroyed after, or over the group that exists.  ``batch`` and ``seq``
    replace the shape's global batch and length (the record keeps the
    shape's name; its ``model_flops`` is the run's)."""
    if seq_parallel:
        raise SystemExit(SEQ_PARALLEL)
    with _production(mesh, multi_pod, rank) as mesh:
        t0 = time.perf_counter()
        lowered, meta, cfg = lower_pair(arch_id, shape_id, multi_pod=multi_pod, mesh=mesh,
                                        int8=int8, batch=batch, seq=seq)
        setup = time.perf_counter() - t0
        shardctx.reset_counts()
        t0 = time.perf_counter()
        with shardctx.use_mesh(mesh):
            _, counted = count.count_step(lowered.step, lowered.args)
        wall = time.perf_counter() - t0
        colls = shardctx.counts()
    ratio = lowered.int8_ratio
    del lowered
    mem = _mem_stats(counted)
    cost = {"flops": counted["flops"], "bytes accessed": counted["bytes"],
            "aten flops": counted["aten_flops"], "aten bytes accessed": counted["aten_bytes"],
            "kernel flops": counted["kernel_flops"],
            "kernel bytes accessed": counted["kernel_bytes"],
            "kernels": counted["kernels"], "setup_s": round(setup, 2)}
    if ratio is not None:
        cost["int8_ratio"] = ratio
    coll = _collectives(colls)
    trips = loop_trips(cfg, meta["kind"], SHAPES[shape_id].seq_len, meta.get("num_micro", 1))
    terms = roofline_terms(cfg, meta, counted, coll["total"], batch=batch, seq=seq)
    rec = {**meta, "multi_pod": multi_pod, "loop_trips": list(trips),
           "lower_s": round(wall, 2), "compile_s": 0.0,
           "memory": mem, "cost": cost, "collectives": coll,
           "hlo_flops_per_chip": counted["flops"],
           "hlo_traffic_per_chip": counted["bytes"],
           "op_histogram": counted["op_histogram"][:12],
           "roofline": terms}
    if verbose:
        print(f"[dryrun] {arch_id} x {shape_id} mesh={meta['mesh']} step={wall:.1f}s "
              f"(setup {setup:.1f}s)")
        print("  memory:", json.dumps(mem))
        print("  counted: flops/rank=%.3e bytes/rank=%.3e" % (counted["flops"], counted["bytes"]))
        print("  collectives:", json.dumps({k: v for k, v in coll.items() if k != "counts"}),
              json.dumps(coll["counts"]))
        print("  roofline:", json.dumps(terms))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, record_name(arch_id, shape_id, multi_pod, int8)),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def record_name(arch_id: str, shape_id: str, multi_pod: bool, int8: bool) -> str:
    tag = ("multi" if multi_pod else "single") + ("_int8" if int8 else "")
    return f"{arch_id}__{shape_id}__{tag}.json"


def comms_summary(arch_id: str, shape_id: str, *, multi_pod: bool = False,
                  mesh=None, rank: int = 0) -> dict:
    """A stable view of one pair's collectives on a rank: what its step
    moves, by kind, counted as it runs (``shardctx``).  The calibration
    target of the reference's ``repro.core.distributed.plan_shards``
    (within 10 % of ``per_shard_bytes`` for a decode step) and of
    ``launch/comms.py``'s plan (equal, kind by kind).

    Keys (an API): ``arch``, ``shape``, ``kind``, ``mesh``, ``axes``,
    ``model_parallel`` (the model axis's size), ``loop_trips`` (recorded
    only), ``counts`` (collectives by kind), ``per_kind`` (a rank's ring
    bytes by kind), ``per_shard_bytes`` (their sum: one rank, one step),
    ``total_bytes`` (every rank of the model axis)."""
    with _production(mesh, multi_pod, rank) as mesh:
        lowered, meta, cfg = lower_pair(arch_id, shape_id, multi_pod=multi_pod, mesh=mesh)
        shardctx.reset_counts()
        with shardctx.use_mesh(mesh):
            lowered.step(*lowered.args)
        colls = shardctx.counts()
        msz = axis_size(mesh, model_axis(mesh))
    per_kind = {k: b for k, (_, b) in colls.items()}
    per_shard = float(sum(per_kind.values()))
    trips = loop_trips(cfg, meta["kind"], SHAPES[shape_id].seq_len, meta.get("num_micro", 1))
    return {"arch": arch_id, "shape": shape_id, "kind": meta["kind"],
            "mesh": meta["mesh"], "axes": meta["axes"],
            "model_parallel": int(msz), "loop_trips": list(trips),
            "counts": {k: n for k, (n, _) in colls.items()}, "per_kind": per_kind,
            "per_shard_bytes": per_shard, "total_bytes": per_shard * int(msz)}


def main(argv=None):
    ap = argparse.ArgumentParser(description="one rank's step of every (arch x shape) "
                                             "pair on meta tensors under a fake group")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rank", type=int, default=0, help="the rank whose step runs")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 ablation (prefill/decode kinds)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the reference's sequence parallelism: not ported, refused")
    args = ap.parse_args(argv)
    if args.seq_parallel:
        raise SystemExit(SEQ_PARALLEL)
    if args.all:
        todo = registry.pairs()
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures, t0 = [], time.perf_counter()
    with fake_group(production_world(args.multi_pod), args.rank):
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        for aid, sid in todo:
            path = os.path.join(args.out, record_name(aid, sid, args.multi_pod, args.int8))
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] skip existing {path}")
                continue
            try:
                run_pair(aid, sid, multi_pod=args.multi_pod, out_dir=args.out, mesh=mesh,
                         int8=args.int8)
            except Exception as e:
                traceback.print_exc()
                failures.append((aid, sid, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"[dryrun] all {len(todo)} pair(s) ran OK "
          f"({'multi' if args.multi_pod else 'single'}-pod mesh) in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
