"""The port's dry-run (``repro_torch.launch.dryrun``) and its analysis
(``analysis/count.py``, ``roofline.py``, ``report.py``), against the
reference's contracts.

Every case runs one rank's full-width step on meta tensors inside a ``fake``
process group of the mesh's world, made and destroyed by
``dryrun.fake_group`` (its ``finally``), so no group outlives a test.  The
contracts are those of the reference's dry-run tests
(``tests/test_sharding_dryrun.py``, ``tests/test_distributed.py``), which
fail on this tree: the reduced (2, 2) mesh for three pairs, the (2, 2, 2)
pod mesh, the int8 ablation, ``comms_summary`` against the reference's
``plan_shards``.  Where a case's step would run many microbatches (a train
pair at (2, 2) splits 128 rows a data rank into 128 microbatches, each a
whole forward and backward here), it runs a smaller global batch; the
(16, 16) sweeps run every pair at its full shape (``PERF.md``).
"""
from __future__ import annotations

import contextlib
import math

import jax
import pytest
import torch

from repro.analysis import roofline as ref_roofline
from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core.distributed import plan_shards
from repro_torch import shardctx
from repro_torch.analysis import count, report, roofline
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import dispatch
from repro_torch.kernels.attention import flash, flash_bwd
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref, flash_attention_fwd_ref,
                                               flash_attention_ref)
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.decode.ref import flash_decode_ref
from repro_torch.kernels.optim import adamw
from repro_torch.kernels.optim.ref import grad_sumsq_ref
from repro_torch.kernels.rwkv import wkv, wkv_bwd
from repro_torch.kernels.rwkv.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.launch import comms, dryrun, sharding
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import api, layers, ssm
from repro_torch.models.common import leaf_paths, tensor_leaves

# the keys of the reference's run_pair record (src/repro/launch/dryrun.py:
# lower_pair's meta and meta_extra, :124-128, num_micro for a train step,
# :141; run_pair's rec, :212-218)
REF_KEYS = {"arch", "shape", "kind", "mesh", "axes", "n_devices", "fsdp", "int8",
            "replicated_weights", "multi_pod", "loop_trips", "lower_s", "compile_s",
            "memory", "cost", "collectives", "hlo_flops_per_chip", "hlo_traffic_per_chip",
            "op_histogram", "roofline"}
# comms_summary's stable keys (src/repro/launch/dryrun.py:255-261)
COMMS_KEYS = ("arch", "shape", "kind", "mesh", "axes", "model_parallel", "loop_trips",
              "counts", "per_kind", "per_shard_bytes", "total_bytes")
# the operations behind PERF.md's 6.306 ms bound of deepseek-7b's (4, 128)
# prefill at 989 TFLOP/s
DEEPSEEK_PREFILL_FLOPS = 6.24e12


@contextlib.contextmanager
def _mesh(*sizes, names=("data", "model")):
    with dryrun.fake_group(math.prod(sizes)):
        yield make_local_mesh(*sizes, names=names, device="meta")


def _plan(arch: str, mesh, batch: int, cache_len: int) -> dict:
    return comms.decode_step(registry.get(arch).config, mesh.shape, batch=batch,
                             cache_len=cache_len)


def test_pairs_and_input_specs_are_the_references():
    assert registry.pairs() == ref_registry.pairs()
    assert len(registry.pairs()) == 39
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in REF_SHAPES.items()}
    for arch, shape in registry.pairs(include_unsupported=True):
        kind, cfg, kw = registry.input_specs(arch, shape, smoke=True)
        ref_kind, _, ref_kw = ref_registry.input_specs(arch, shape, smoke=True)
        assert kind == ref_kind and set(kw) == set(ref_kw), (arch, shape)
        for key, spec in ref_kw.items():
            if key == "cache":
                ref = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                       tuple(x.shape)
                       for path, x in jax.tree_util.tree_flatten_with_path(spec)[0]}
                assert {tuple(map(str, p)): tuple(t.shape) for p, t in zip(
                    leaf_paths(kw[key]), tensor_leaves(kw[key]))} == ref, (arch, shape)
            elif key == "pos":     # the reference's scalar position: the last one
                assert kw[key] == min(SHAPES[shape].seq_len, 16) - 1
            else:
                assert tuple(kw[key].shape) == tuple(spec.shape), (arch, shape, key)
                assert kw[key].device.type == "meta"


def test_production_meshes_group_every_tuple_of_axes():
    for multi_pod, world in ((False, 256), (True, 512)):
        with dryrun.fake_group(world, rank=37):
            mesh = make_production_mesh(multi_pod=multi_pod)
            names = ("pod", "data", "model") if multi_pod else ("data", "model")
            assert mesh.axis_names == names and mesh.device.type == "meta"
            # rank 37 row-major: (pod, data, model) = (0, 2, 5)
            assert [mesh.coords[a] for a in names] == ([0, 2, 5] if multi_pod else [2, 5])
            assert mesh.index(("pod", "data")) == 2 and mesh.index(names) == 37
            for axes, group in mesh.groups.items():
                assert torch.distributed.get_world_size(group) == mesh.size(axes), axes
            want = {(a,) for a in names} | {names}
            if multi_pod:
                want |= {("pod", "data"), ("pod", "model"), ("data", "model")}
            assert set(mesh.groups) == want
        assert not torch.distributed.is_initialized()


def test_a_group_of_another_world_is_an_error_not_replaced():
    with dryrun.fake_group(4):
        with pytest.raises(RuntimeError, match="4 ranks"):
            with dryrun.fake_group(8):
                pass
        assert torch.distributed.get_world_size() == 4
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,shape,batch", [
    ("deepseek-7b", "decode_32k", None),
    ("rwkv6-1.6b", "train_4k", 4),
    ("qwen3-moe-235b-a22b", "prefill_32k", None),
    ("resnet18", "decode_32k", 8),      # a CNN's forward, the kind "predict"
])
def test_dryrun_reduced_mesh(arch, shape, batch):
    with _mesh(2, 2) as mesh:
        rec = dryrun.run_pair(arch, shape, multi_pod=False, out_dir="", verbose=False,
                              mesh=mesh, batch=batch)
    t = rec["roofline"]
    assert t["bound_time_s"] > 0 and t["dominant"] in ("compute", "memory", "collective")
    assert t["bound_time_s"] == max(t["compute_s"], t["memory_s"], t["collective_s"])
    assert set(rec) == REF_KEYS | ({"num_micro"} if rec["kind"] == "train" else set())
    assert rec["mesh"] == [2, 2] and rec["n_devices"] == 4 and rec["compile_s"] == 0.0
    assert rec["memory"]["total_bytes_per_device"] > 0 and rec["hlo_flops_per_chip"] > 0
    assert rec["collectives"]["total"] == sum(
        v for k, v in rec["collectives"].items() if k not in ("total", "counts"))
    # the kernels of the pair ran their meta routes, counted in the FLOPs
    kernels = rec["cost"]["kernels"]
    want = {"decode": {"flash_decode"}, "prefill": {"flash_attention"},
            "train": {"wkv6", "wkv6_bwd", "grad_sumsq", "adamw_update"},
            "predict": set()}[rec["kind"]]
    assert want <= set(kernels), kernels
    assert rec["cost"]["flops"] == pytest.approx(
        rec["cost"]["aten flops"] + sum(k["flops"] for k in kernels.values()))


def test_multi_pod_mesh_runs_a_train_step():
    with _mesh(2, 2, 2, names=("pod", "data", "model")) as mesh:
        rec = dryrun.run_pair("deepseek-7b", "train_4k", multi_pod=True, out_dir="",
                              verbose=False, mesh=mesh, batch=8)
    assert rec["axes"] == ["pod", "data", "model"] and rec["mesh"] == [2, 2, 2]
    assert rec["roofline"]["bound_time_s"] > 0 and rec["fsdp"] and rec["multi_pod"]
    # FSDP's gathers and their gradients' reduce-scatters, the gradient sums
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(rec["collectives"]["counts"])
    assert rec["cost"]["kernels"]["adamw_update"]["calls"] == 1


def _weight_bytes(rec) -> int:
    """A decode step's argument bytes less its cache (aliased) and tokens."""
    m = rec["memory"]
    return m["argument_size_in_bytes"] - m["alias_size_in_bytes"]


def test_int8_halves_the_weights():
    with _mesh(2, 2) as mesh:
        bf16 = dryrun.run_pair("mistral-nemo-12b", "decode_32k", multi_pod=False, out_dir="",
                               verbose=False, mesh=mesh)
        int8 = dryrun.run_pair("mistral-nemo-12b", "decode_32k", multi_pod=False, out_dir="",
                               verbose=False, mesh=mesh, int8=True)
    assert int8["int8"] is True and bf16["int8"] is False
    ratio = _weight_bytes(int8) / _weight_bytes(bf16)
    assert ratio < 0.6, ratio
    assert ratio == pytest.approx(int8["cost"]["int8_ratio"], rel=0.02)
    # the dequantized weights run the same step: the same FLOPs
    assert int8["cost"]["kernel flops"] == bf16["cost"]["kernel flops"]


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen1.5-110b"])
def test_comms_summary_matches_the_plans(arch):
    with _mesh(1, 4) as mesh:
        s = dryrun.comms_summary(arch, "decode_32k", mesh=mesh)
        plan = _plan(arch, mesh, 128, 32768)
    for key in COMMS_KEYS:
        assert key in s, key
    assert s["arch"] == arch and s["kind"] == "decode" and s["model_parallel"] == 4
    assert s["per_shard_bytes"] > 0
    assert s["total_bytes"] == pytest.approx(4 * s["per_shard_bytes"])
    assert s["per_shard_bytes"] == pytest.approx(sum(s["per_kind"].values()))
    # the reference's 10 % gate against its analytic plan
    batch = REF_SHAPES["decode_32k"].global_batch
    analytic = plan_shards(arch, 4, batch=batch).step_bytes(batch)
    assert abs(analytic - s["per_shard_bytes"]) / s["per_shard_bytes"] < 0.10
    # and the port's plan, kind by kind
    assert {k: (s["counts"][k], s["per_kind"][k]) for k in s["counts"]} == plan


def test_ssm_decode_plan_equals_its_count():
    """RWKV-6's decode plan (``launch/comms.py``) against the meta count at
    (1, 4) and (16, 16); at (16, 16) also against the step's count before
    the plan existed: 25 all-reduces of 3,072,000 B, 121 all-gathers of
    6,816,000 B."""
    for sizes in ((1, 4), (16, 16)):
        with _mesh(*sizes) as mesh:
            s = dryrun.comms_summary("rwkv6-1.6b", "decode_32k", mesh=mesh)
            plan = _plan("rwkv6-1.6b", mesh, 128, 32768)
        got = {k: (s["counts"][k], s["per_kind"][k]) for k in s["counts"]}
        assert got == plan, sizes
    assert plan == {"all-reduce": (25, 3072000.0), "all-gather": (121, 6816000.0)}


def test_fsdp_serving_step_gathers_its_shards():
    """qwen1.5-110b's decode at (2, 2): 111 B weights over a model axis of 2
    pass 4 GB, so FSDP cuts them over "data" too, and the step gathers
    every such leaf: the all-gathers are the plan's plus one a cut leaf."""
    with _mesh(2, 2) as mesh:
        rec = dryrun.run_pair("qwen1.5-110b", "decode_32k", multi_pod=False, out_dir="",
                              verbose=False, mesh=mesh)
        cfg = registry.get("qwen1.5-110b").config
        specs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh, fsdp=True)
        cut = sum(1 for spec in sharding.spec_leaves(specs) if sharding.fsdp_cuts(spec, mesh))
        plan = _plan("qwen1.5-110b", mesh, 128, 32768)
    assert rec["fsdp"] and cut > 700
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] == plan["all-gather"][0] + cut
    assert counts["all-reduce"] == plan["all-reduce"][0]
    assert rec["collectives"]["all-gather"] > plan["all-gather"][1]


def test_replicated_weights_prefill_sees_whole_weights(monkeypatch):
    """rwkv6-1.6b's prefill at prefill_32k's shape on (2, 2): under 4 GB and
    not MoE, so its weights are replicated and the model code, asking the
    rules as always, is told every leaf is whole; nothing moves between
    ranks."""
    answers = []

    def recording(keys, shape, **kw):
        answers.append(sharding.model_cut(keys, shape, **kw))
        return answers[-1]

    monkeypatch.setattr(ssm, "model_cut", recording)
    monkeypatch.setattr(layers, "model_cut", recording)
    with _mesh(2, 2) as mesh:
        rec = dryrun.run_pair("rwkv6-1.6b", "prefill_32k", multi_pod=False, out_dir="",
                              verbose=False, mesh=mesh)
        view = sharding.replicated(mesh)
        assert view.shape == {"data": 2, "model": 1} and view.group("data") is mesh.group("data")
        assert view.group(("data", "model")) is mesh.group("data")
        # under the mesh itself the rules do cut
        with shardctx.use_mesh(mesh):
            assert sharding.model_cut(("wo", "w"), (2048, 2048)) == 0
    assert rec["replicated_weights"] and not rec["fsdp"]
    assert answers and all(a is None for a in answers)
    assert rec["collectives"]["counts"] == {}
    assert rec["cost"]["kernels"]["wkv6"]["calls"] == 24 * 4   # 4 chunks of 8,192


def test_deepseek_prefill_counts_the_bound_operations():
    """The FLOPs of deepseek-7b's (4, 128) prefill on one rank, within 1 % of
    the 6.24 TFLOP behind PERF.md's bound; the aten share equal to
    ``FlopCounterMode``'s own count of the same step."""
    from torch.utils.flop_counter import FlopCounterMode
    with _mesh(1, 1) as mesh:
        rec = dryrun.run_pair("deepseek-7b", "prefill_32k", multi_pod=False, out_dir="",
                              verbose=False, mesh=mesh, batch=4, seq=128)
        lowered, _, _ = dryrun.lower_pair("deepseek-7b", "prefill_32k", multi_pod=False,
                                          mesh=mesh, batch=4, seq=128)
        with shardctx.use_mesh(mesh), FlopCounterMode(display=False) as fc:
            lowered.step(*lowered.args)
    assert rec["cost"]["flops"] == pytest.approx(DEEPSEEK_PREFILL_FLOPS, rel=0.01)
    assert rec["cost"]["aten flops"] == fc.get_total_flops()
    attn = rec["cost"]["kernels"]["flash_attention"]
    assert attn["calls"] == 30 and attn["flops"] == 30 * 4 * 128 * 4 * 32 * (128 * 129 // 2)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_the_references(kind):
    for arch in registry.ARCHS:
        cfg, ref_cfg = registry.get(arch).config, ref_registry.get(arch).config
        for batch, seq in ((256, 4096), (32, 32768), (1, 524288)):
            assert roofline.model_flops(cfg, kind, batch, seq) == \
                ref_roofline.model_flops(ref_cfg, kind, batch, seq), (arch, kind)


def test_roofline_terms_dominance():
    cfg = registry.get("deepseek-7b").config
    meta = {"n_devices": 256, "shape": "train_4k", "kind": "train"}
    t = roofline.roofline_terms(cfg, meta, {"flops": 1e15, "bytes": 1e12}, 1e9)
    assert t["dominant"] == "compute"
    assert t["compute_s"] > t["memory_s"] > t["collective_s"]
    assert t["model_flops"] > 0 and t["bound_time_s"] == t["compute_s"]
    assert t["compute_s"] == pytest.approx(1e15 / 989e12)
    assert t["collective_s"] == pytest.approx(1e9 / 450e9)


def test_the_cli_writes_records_the_report_reads(tmp_path, capsys):
    """``main`` as rank 5 of the production (16, 16) mesh, under a fake
    group it makes and takes down, then ``--skip-existing``."""
    out = ["--arch", "whisper-tiny", "--shape", "decode_32k", "--out", str(tmp_path)]
    dryrun.main(out + ["--rank", "5"])
    assert not torch.distributed.is_initialized()
    rec = roofline.load_records(str(tmp_path))
    assert len(rec) == 1 and rec[0]["mesh"] == [16, 16] and rec[0]["n_devices"] == 256
    dryrun.main(out + ["--skip-existing"])
    assert "skip existing" in capsys.readouterr().out
    table = report.roofline_md(str(tmp_path))
    assert "fits 80 GB" in table and "| whisper-tiny | decode_32k |" in table
    assert "**1** pairs" in report.dryrun_md(str(tmp_path))
    grid = report.meshes_md(str(tmp_path)).splitlines()
    assert grid[0] == "| arch | decode_32k |" and grid[2].startswith("| whisper-tiny | ")
    assert grid[2].endswith(" / - |")
    assert "whisper-tiny" in roofline.table(roofline.load_records(str(tmp_path)))


def _counts(rec) -> dict:
    """A record's collectives as {kind: (count, a rank's bytes)}."""
    coll = rec["collectives"]
    return {k: (n, coll[k]) for k, n in coll["counts"].items()}


def _minus(a: dict, b: dict) -> dict:
    out = {}
    for k in set(a) | set(b):
        n = a.get(k, (0, 0.0))[0] - b.get(k, (0, 0.0))[0]
        nbytes = a.get(k, (0, 0.0))[1] - b.get(k, (0, 0.0))[1]
        if n or nbytes:
            out[k] = (n, nbytes)
    return out


# (arch, shape, batch, seq): every shape kind, the dense, moe, ssm and hybrid
# families; prefills and train steps at a reduced batch and length
SP_PAIRS = [("deepseek-7b", "prefill_32k", 4, 256), ("granite-moe-3b-a800m", "prefill_32k", 4, 256),
            ("recurrentgemma-9b", "prefill_32k", 4, 256), ("deepseek-7b", "train_4k", 4, 256),
            ("rwkv6-1.6b", "train_4k", 4, 256), ("recurrentgemma-9b", "train_4k", 4, 96),
            ("deepseek-7b", "decode_32k", None, None), ("rwkv6-1.6b", "decode_32k", None, None),
            ("recurrentgemma-9b", "long_500k", None, None)]


@pytest.mark.parametrize("arch,shape,batch,seq", SP_PAIRS)
def test_seq_parallel_dryrun_counts_equal_the_plan(arch, shape, batch, seq):
    """A ``--seq-parallel`` step on the reduced (2, 2) mesh against the same
    step without the flag: a decode step counts exactly the same; a
    prefill's and a train step's collectives move as ``comms``' plans with
    and without the flag differ (FSDP's gathers and reduce-scatters, the
    data means and the grad norm are the flag's to leave alone), and a
    prefill whose weights FSDP does not cut counts its plan exactly."""
    with _mesh(2, 2) as mesh:
        tp = dryrun.run_pair(arch, shape, multi_pod=False, out_dir="", verbose=False,
                             mesh=mesh, batch=batch, seq=seq)
        sp = dryrun.run_pair(arch, shape, multi_pod=False, out_dir="", verbose=False,
                             mesh=mesh, batch=batch, seq=seq, seq_parallel=True)
    assert sp["seq_parallel"] is True and "seq_parallel" not in tp
    cfg = registry.get(arch).config
    if sp["kind"] == "decode":
        assert _counts(sp) == _counts(tp) and _counts(sp)
        return
    if sp["kind"] == "train":
        want = [comms.train_step(cfg, mesh.shape, batch=batch, seq=seq, seq_parallel=f,
                                 fsdp=sp["fsdp"]) for f in (True, False)]
    else:
        want = [comms.prefill(cfg, mesh.shape, batch=batch, seq=seq, seq_parallel=f)
                for f in (True, False)]
    assert sp.get("num_micro", 1) == 1
    assert _minus(_counts(sp), _counts(tp)) == _minus(*want)
    assert _counts(sp)["reduce-scatter"][0] > _counts(tp).get("reduce-scatter", (0,))[0]
    if not sp["fsdp"]:
        assert _counts(sp) == want[0] and _counts(tp) == want[1]


def test_the_cli_writes_seq_parallel_records_the_report_reads(tmp_path, capsys):
    """``main --seq-parallel`` on the production (16, 16) mesh writes a
    ``_sp`` record beside the flag-less one; the report grids each apart
    and sets them side by side (HBM a rank and ``collective_s``)."""
    out = ["--arch", "deepseek-7b", "--shape", "prefill_32k", "--out", str(tmp_path)]
    dryrun.main(out)
    dryrun.main(out + ["--seq-parallel"])
    assert "sequence parallel" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "deepseek-7b__prefill_32k__single.json", "deepseek-7b__prefill_32k__single_sp.json"]
    recs = {bool(r.get("seq_parallel")): r for r in roofline.load_records(str(tmp_path))}
    assert recs[True]["collectives"]["total"] < recs[False]["collectives"]["total"]
    assert recs[True]["roofline"]["collective_s"] < recs[False]["roofline"]["collective_s"]
    for flag in (False, True):
        grid = report.meshes_md(str(tmp_path), seq_parallel=flag).splitlines()
        assert grid[0] == "| arch | prefill_32k |" and len(grid) == 3
    rows = report.seq_parallel_md(str(tmp_path)).splitlines()
    assert rows[0] == "| arch | prefill_32k |" and rows[2].startswith("| deepseek-7b | ")
    assert "→" in rows[2] and " GB " in rows[2] and rows[2].endswith(" / - |")
    assert "**1** pairs" in report.dryrun_md(str(tmp_path))
    assert "**1** pairs" in report.dryrun_md(str(tmp_path), seq_parallel=True)


# ----------------------------------------------------------------------
# each kernel's meta route: the plain version's shapes and dtypes, no loop
# ----------------------------------------------------------------------

def _cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    b, s, h, kh, hd = 2, 8, 4, 2, 16
    q, k, v = r(b, s, h, hd), r(b, s, kh, hd), r(b, s, kh, hd)
    o, lse = flash_attention_fwd_ref(q, k, v)
    dq = r(b, 1, h, hd)
    valid = torch.arange(s)[None].repeat(b, 1) < torch.tensor([[5], [8]])
    t, rh, rhd = 3, 2, 4
    rk = [r(b, t, rh, rhd) for _ in range(4)]
    u, s0 = r(rh, rhd), r(b, rh, rhd, rhd)
    grads = [r(3, 5, dtype=torch.bfloat16), r(7, dtype=torch.bfloat16)]
    return {
        "flash_attention": (lambda x: dispatch.flash_attention(*x, window=3), (q, k, v),
                            lambda x: flash_attention_ref(*x, window=3)),
        "flash_attention lse": (lambda x: dispatch.flash_attention_fwd(*x), (q, k, v),
                                lambda x: flash_attention_fwd_ref(*x)),
        "flash_attention_bwd": (lambda x: dispatch.flash_attention_bwd(*x),
                                (q, k, v, o, r(b, s, h, hd), lse),
                                lambda x: flash_attention_bwd_ref(*x)),
        "flash_decode": (lambda x: dispatch.flash_decode(*x), (dq, k, v, valid),
                         lambda x: flash_decode_ref(*x)),
        "flash_decode lse": (lambda x: dispatch.flash_decode(*x, return_lse=True),
                             (dq, k, v, valid[0]),
                             lambda x: flash_decode_ref(*x, return_lse=True)),
        "wkv6": (lambda x: dispatch.rwkv_scan(*x), (*rk, u, s0), lambda x: wkv6_ref(*x)),
        "wkv6 in place": (lambda x: dispatch.rwkv_scan(*x, out_state=x[-1]), (*rk, u, s0),
                          lambda x: wkv6_ref(*x)),
        "wkv6_bwd": (lambda x: dispatch.wkv6_bwd(*x), (*rk, u, s0, r(b, t, rh, rhd), s0),
                     lambda x: wkv6_bwd_ref(*x)),
        "grad_sumsq": (lambda x: dispatch.grad_sumsq(x), grads, grad_sumsq_ref),
    }


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    return type(x)(_meta(y) for y in x)


def _on_meta(shapes):
    if isinstance(shapes[-1], str):
        return (*shapes[:-1], "meta")
    return tuple(_on_meta(x) for x in shapes)


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype, out.device.type)
    return tuple(_shapes(y) for y in out)


@pytest.mark.parametrize("name", list(_cases()))
def test_kernel_meta_route_gives_the_plain_versions_shapes(name, monkeypatch):
    fn, args, plain = _cases()[name]
    want = _shapes(plain(args))
    # no plain version and no kernel runs on meta
    for mod, attr in ((dispatch, "flash_attention_ref"), (dispatch, "flash_attention_fwd_ref"),
                      (dispatch, "flash_attention_bwd_ref"), (dispatch, "flash_decode_ref"),
                      (dispatch, "wkv6_ref"), (dispatch, "wkv6_bwd_ref"),
                      (dispatch, "grad_sumsq_ref"), (dispatch, "adamw_update_ref"),
                      (flash, "flash_attention"), (flash_bwd, "flash_attention_bwd"),
                      (fd, "flash_decode"), (wkv, "wkv6"), (wkv_bwd, "wkv6_bwd"),
                      (adamw, "grad_sumsq"), (adamw, "adamw_update")):
        monkeypatch.setattr(mod, attr, lambda *a, **k: pytest.fail("ran on meta"))
    dispatch.reset_work()
    assert _shapes(fn(_meta(args))) == _on_meta(want)
    (calls, flops, nbytes), = dispatch.work().values()
    assert calls == 1 and flops > 0 and nbytes > 0


def test_adamw_meta_route_counts_22_bytes_a_bf16_param():
    params = [torch.empty(3, 5, dtype=torch.bfloat16, device="meta")]
    grads = [torch.empty(3, 5, dtype=torch.bfloat16, device="meta")]
    mu, nu = ([torch.empty(3, 5, device="meta")] for _ in range(2))
    dispatch.reset_work()
    dispatch.adamw_update(params, grads, mu, nu, torch.empty(4, device="meta"), b1=0.9,
                          b2=0.95, eps=1e-8, weight_decay=0.1)
    assert dispatch.work() == {"adamw_update": (1, 17 * 15.0, 22 * 15 + 16.0)}


def test_count_step_tracks_memory_by_storage():
    """Arguments, new outputs, outputs that alias an argument, and the peak
    of the intermediates: a view counts nothing, a freed temporary leaves
    the peak where it was; the peak less the new outputs is the temp, so
    that argument, output and temp add up to the step's peak."""
    x = torch.empty(1000, device="meta")          # 4,000 B argument

    def step(x):
        a = x * 2                                 # 4,000 B live
        b = a.view(10, 100) + 1                   # 8,000 B live
        del a
        c = b.sum(0)                              # 400 B output
        x.add_(1)                                 # the argument, in place
        return c, x

    _, got = count.count_step(step, (x,))
    assert got["argument_bytes"] == 4000 and got["output_bytes"] == 400
    assert got["alias_bytes"] == 4000 and got["temp_bytes"] == 8000 - 400
    # x*2: 8,000; +1: 8,000; sum: 4,400; add_: 8,000
    assert got["bytes"] == 28400 and got["flops"] == 0
