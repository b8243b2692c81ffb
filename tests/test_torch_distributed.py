"""The port's sharded paths on the CPU: gloo ranks of one host, started by
``repro_torch.launch.mesh.spawn`` (``torch.multiprocessing``, a
``FileStore`` in a temporary directory), with a 60 s process-group timeout
so that a hung collective fails instead of running the suite out of time.

Three spawns do all the work, each with its own time limit (its ranks are
killed when one fails): four ranks on the (2, 2) and (1, 4) meshes, two
ranks on (1, 2) and (2, 1), then eight on (1, 8) (``tests/_torch_ranks.py``).  Every rank writes
what it measured; the tests below, and those of
``tests/test_torch_seq_parallel.py``, read it.  The spawns run once a
session (``spawned``): under xdist the first worker to ask runs them under
a lock in the session's shared temporary directory, the others read what
it wrote.  The oracles: the reference's
``moe_apply`` (its own cases from ``tests/test_distributed.py``, weights from
its ``moe_init`` through numpy), the reference's single-device ``prefill``
and the port's single-device path on the same seeded weights (the
reference's own sharded train test fails at this tree, so the train steps
are held to the port's), ``core/distributed.py::plan_shards``' bytes, and
the reference's checkpoint ``restore``.
"""
from __future__ import annotations

import fcntl
import json
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import distributed as ref_distributed
from repro.launch import sharding as ref_sharding
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro.models.common import ModelConfig as RefConfig
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import registry
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn
from repro_torch.models import api, convert
from repro_torch.models.common import leaf_paths

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks as ranks  # noqa: E402

LOGITS_TOL = 1e-5
MOE_TOL = 1e-5
TRAIN_TOL = 1e-5       # loss and grad norm, relative
PARAM_TOL = 1e-4       # params after one AdamW step, relative L2 per leaf
SPAWN_S = 240
PG_TIMEOUT_S = 60


def _moe_case(path: str, experts: int, seed: int, batch: int) -> None:
    """The reference's case of ``tests/test_distributed.py``: its weights,
    its input and its single-device output and loss, as numpy."""
    cfg = RefConfig(name="m", family="moe", num_layers=1, d_model=32, num_heads=2,
                    num_kv_heads=2, d_ff=16, vocab_size=64, num_experts=experts,
                    num_experts_per_tok=2, moe_capacity_factor=2.0,
                    param_dtype="float32", compute_dtype="float32")
    rng = jax.random.PRNGKey(seed)
    p = ref_moe.moe_init(rng, cfg)
    x = jax.random.normal(rng, (batch, 8, 32))
    y, aux = ref_moe.moe_apply(p, x, cfg)
    np.savez(path, num_experts=experts, router=np.asarray(p["router"]["w"]),
             wi=np.asarray(p["wi"]), wu=np.asarray(p["wu"]), wd=np.asarray(p["wd"]),
             x=np.asarray(x), y=np.asarray(y), aux=np.asarray(aux))


def _read(prefix: str, world: int) -> list:
    out = []
    for r in range(world):
        with open(f"{prefix}.rank{r}.json") as f:
            out.append(json.load(f))
    return out


def _spawn_all(d) -> None:
    """The three spawns into directory ``d``, the four ranks first (they
    write the checkpoint that the two restore)."""
    _moe_case(str(d / "ep.npz"), 4, 0, 4)
    _moe_case(str(d / "tpf.npz"), 3, 1, 2)
    ckpt = str(d / "ckpt" / "sharded")
    spawn(ranks.world4, 4, (str(d / "w4"), str(d), ckpt), device="cpu", timeout_s=SPAWN_S,
          pg_timeout_s=PG_TIMEOUT_S)
    spawn(ranks.world2, 2, (str(d / "w2"), ckpt), device="cpu", timeout_s=SPAWN_S,
          pg_timeout_s=PG_TIMEOUT_S)
    spawn(ranks.world8, 8, (str(d / "w8"),), device="cpu", timeout_s=SPAWN_S,
          pg_timeout_s=PG_TIMEOUT_S)


def spawned(tmp_path_factory) -> dict:
    """The spawns' results, run once a session.  -> {"4": [per rank], "2":
    [per rank], "8": [per rank], paths}.  Under xdist every worker shares
    the session's base temporary directory (its own's parent): the first
    to take the lock there runs the spawns and marks them done; a run that
    failed left no mark, so the next worker runs them anew."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch-spawns"
    with open(root / "torch-spawns.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (d / "done").exists():
                shutil.rmtree(d, ignore_errors=True)
                d.mkdir()
                _spawn_all(d)
                (d / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return {"4": _read(str(d / "w4"), 4), "2": _read(str(d / "w2"), 2),
            "8": _read(str(d / "w8"), 8), "dir": d, "ckpt": str(d / "ckpt" / "sharded")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawned(tmp_path_factory)


def _result(runs, world: str, name: str) -> list:
    """Every rank's result of a check; fails with a rank's error."""
    got = [r[name] for r in runs[world]]
    for r, g in enumerate(got):
        assert not (isinstance(g, dict) and "error" in g), f"rank {r}: {g.get('traceback')}"
    return got


@pytest.mark.parametrize("case", ["ep", "tpf"])
def test_moe_matches_the_reference_moe_apply(runs, case):
    """EP (4 experts over 2) and TP-f (3 experts: each rank an ffn slice) at
    (2, 2) against the reference's single-device ``moe_apply``."""
    z = np.load(runs["dir"] / f"{case}.npz")
    for res in _result(runs, "4", f"moe {case} 2x2"):
        assert res["ep"] == (case == "ep")
        assert res["wi_local"] == ([2, 32, 16] if case == "ep" else [3, 32, 8])
        np.testing.assert_allclose(np.array(res["y"]), z["y"], atol=MOE_TOL, rtol=MOE_TOL)
        assert abs(res["aux"] - float(z["aux"])) <= MOE_TOL


CELLS = [(arch, world, mesh) for arch in ranks.MODELS
         for world, mesh in (("2", "1x2"), ("2", "2x1"), ("4", "2x2"))] + [
             (arch, "2", mesh) for arch, mesh in ranks.MORE]


@pytest.mark.parametrize("arch,world,mesh", CELLS)
def test_sharded_logits_and_tokens_match_one_device(runs, arch, world, mesh):
    for res in _result(runs, world, f"{arch} {mesh}"):
        assert res["logits_rel"] <= LOGITS_TOL, res["logits_rel"]
        assert res["tokens"] == res["want"] == res["stream"]
        if "wkv_heads" in res:   # K3's heads: this rank's
            cfg = registry.get(arch).smoke
            assert res["wkv_heads"] == cfg.num_heads // int(mesh.split("x")[1])


_REF_LAST: dict = {}


def _reference_last_logits(arch: str, rows: tuple, batch: int = 4,
                           window: int = 0) -> np.ndarray:
    """The reference's single-device ``prefill`` of rows ``rows`` of the
    ranks' ``batch`` prompts (``_torch_ranks._prompts``) on the port's
    seeded weights (``convert.to_reference``), the attention window
    ``window`` where given: the last position's logits, (rows, V)."""
    if (arch, rows, batch, window) not in _REF_LAST:
        cfg = ranks._smoke(arch, window)
        ref_cfg = ref_registry.ARCHS[arch].smoke
        if window:
            ref_cfg = ref_cfg.replace(attention_window=window)
        params = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.detach().numpy()),
            convert.to_reference(api.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                                 cfg))
        toks = ranks._prompts(cfg, batch).numpy()[slice(*rows)]
        inputs = {"tokens": jnp.asarray(toks)}
        if cfg.family == "audio":
            inputs["frame_embeds"] = jnp.zeros((toks.shape[0], cfg.encoder_seq, cfg.d_model))
        if cfg.family == "vlm":
            inputs["patch_embeds"] = jnp.asarray(ranks._patches(cfg).numpy()[slice(*rows)])
        _REF_LAST[(arch, rows, batch, window)] = np.asarray(
            ref_api.prefill(params, inputs, ref_cfg)[0])
    return _REF_LAST[(arch, rows, batch, window)]


@pytest.mark.parametrize("arch,world,mesh", CELLS)
def test_sharded_logits_match_the_reference_prefill(runs, arch, world, mesh):
    """Each rank's last-position logits against the reference's own
    single-device ``prefill`` on the same weights and prompts (a MoE's data
    ranks route their rows in groups of their own, so the reference runs
    each rank's rows apart there)."""
    for res in _result(runs, world, f"{arch} {mesh}"):
        lo, hi = res["rows"]
        if res["per_shard"]:
            want = _reference_last_logits(arch, (lo, hi))
        else:
            want = _reference_last_logits(arch, (0, 4))[lo:hi]
        got = np.array(res["last"])
        assert np.linalg.norm(want) > 0
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LOGITS_TOL, rel


def _plan(arch: str, n: int, batch: int, monkeypatch) -> dict:
    """``plan_shards``' per-rank collectives of one decode step at
    ``batch``, evaluated at the smoke config."""
    smoke = ref_registry.ARCHS[arch].smoke
    monkeypatch.setattr(ref_registry, "get", lambda a: SimpleNamespace(config=smoke))
    plan = ref_distributed.plan_shards(arch, n, batch=batch)
    return {kind: (count, nbytes * batch) for kind, count, nbytes in plan.collectives}


@pytest.mark.parametrize("world,mesh,n", [("2", "1x2", 2), ("4", "1x4", 4)])
def test_decode_step_collectives_equal_plan_shards(runs, world, mesh, n, monkeypatch):
    """One decode step's counted collectives on each rank: 2L+1 all-reduces
    (two a layer and the embedding's) of float32 (b, 1, d) and one float32
    logits all-gather, each with the ring bytes ``plan_shards`` gives."""
    for res in _result(runs, world, f"decode counts {mesh}"):
        want = _plan("deepseek-7b", n, res["batch"], monkeypatch)
        got = {k: tuple(v) for k, v in res["counts"].items()}
        cfg = registry.get("deepseek-7b").smoke
        assert got["all-reduce"][0] == 2 * cfg.num_layers + 1
        assert got == want
        assert res["vocab"] == [res["batch"], cfg.vocab_size]


@pytest.mark.parametrize("name", ["train dp 2x1", "train fsdp micro2 2x1", "train tp 1x2",
                                  "train tp rwkv 1x2", "train tp granite 1x2",
                                  "train dp granite 2x1"])
def test_sharded_train_step_matches_one_device(runs, name):
    for res in _result(runs, "2", name):
        assert abs(res["loss"] - res["want_loss"]) <= TRAIN_TOL * abs(res["want_loss"])
        assert abs(res["gnorm"] - res["want_gnorm"]) <= TRAIN_TOL * abs(res["want_gnorm"])
        assert res["param_rel"] <= PARAM_TOL
        kinds = res["counts"]
        if name.startswith("train dp"):   # the gradients' all-reduce over data, K4's sums
            assert kinds["all-reduce"][0] > 0 and "all-gather" not in kinds
        if "fsdp" in name:     # the weights gathered, the gradients reduce-scattered
            assert kinds["all-gather"][0] > 0 and kinds["reduce-scatter"][0] > 0
            assert res["local_moments"] < res["params"]
        if "tp" in name:
            assert res["local_moments"] < res["params"]


@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-1.6b"])
@pytest.mark.parametrize("layout", ["fsdp", "replicated"])
def test_serving_steps_on_a_mesh_match_one_device(runs, layout, arch):
    """The dry-run's serving steps (``launch/steps.py``) on real data at
    (2, 2): FSDP's weights gathered by the step, or weights replicated under
    the model axis (``sharding.replicated``), give the single device's
    logits; the FSDP steps gather every cut leaf once, the replicated ones
    move nothing."""
    for res in _result(runs, "4", f"serving {layout} {arch} 2x2"):
        for step in ("prefill", "decode"):
            got = res[step]
            assert got["rel"] <= LOGITS_TOL, (step, got["rel"])
            if layout == "replicated":
                assert got["counts"] == {} and got["cut"] == 0
            else:
                assert got["cut"] > 0 and got["counts"]["all-gather"][0] >= got["cut"]


def test_a_sharded_checkpoint_restores_on_other_meshes(runs):
    """Saved at (2, 2) with FSDP specs; restored at (1, 2) (the rank's
    shards, gathered again) and on one device, both equal to the seeded
    params, and by the reference's ``restore``."""
    assert all(r["saved"] for r in _result(runs, "4", "checkpoint save 2x2"))
    for res in _result(runs, "2", "checkpoint restore 1x2"):
        assert res == {"step": 3, "cut": True, "mesh_equal": True, "single_equal": True}
    cfg = registry.get("deepseek-7b").smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    like = {"params": jax.tree_util.tree_map(
        jnp.asarray, ref_api.init_params(jax.random.PRNGKey(0),
                                         ref_registry.ARCHS["deepseek-7b"].smoke))}
    restored, step, _ = ref_ckpt.restore(runs["ckpt"], like)
    assert step == 3
    want = convert.to_reference(params, cfg)
    got, ref_leaves = jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), want))
    assert len(got) == len(ref_leaves)
    for g, w in zip(got, ref_leaves):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("world,name", [("4", "whisper-tiny 1x4"),
                                        ("2", "recurrentgemma-9b 1x2")])
def test_a_checkpoint_of_the_new_layouts_restores(runs, world, name):
    """whisper's heads cut inside over 4 ranks and the hybrid's recurrence
    over 2: the ranks' shards saved in the reference's layout restore into
    the same shards, gather into the seeded params, and restore on a single
    device (``gather_tree``/``shard_tree`` needed no change for them).  The
    restored shards serve as a mesh engine's ``shards`` with the tokens of
    the engine that cuts the whole params; whole params given as shards
    are refused."""
    for res in _result(runs, world, f"checkpoint {name}"):
        assert res == {"step": 2, "shards_equal": True, "mesh_equal": True,
                       "single_equal": True, "engine_tokens_equal": True,
                       "whole_refused": True}


@pytest.mark.parametrize("world,mesh", [("4", "2x2"), ("4", "1x4")])
def test_layouts_left_for_f2_are_refused(runs, world, mesh):
    """The layouts that the port refused, naming slice F2, until it cut
    heads inside and KV sequences: hybrid and audio under a model axis, and
    kv heads that do not divide it (granite's smoke config: 2 kv heads over
    4).  The engine and the train step now build every one of them (what
    they compute is held in ``test_layouts_match_one_device_and_the_
    reference``)."""
    for res in _result(runs, world, f"refusals {mesh}"):
        assert len(res) == (5 if mesh == "1x4" else 4)
        for case, msg in res.items():
            assert msg == "accepted", (case, msg)


LAYOUT_CELLS = [(world, *cell) for world, cells in ranks.LAYOUTS.items() for cell in cells]


def _mesh_shape(mesh: str) -> dict:
    data, model = (int(n) for n in mesh.split("x"))
    return {"data": data, "model": model}


def _reference_seq_cuts(arch: str, mesh: str, batch: int, window: int) -> dict:
    """The axes that the reference's ``cache_pspecs`` cut each attention
    leaf's sequence over, for its smoke cache of ``LAYOUT_CACHE`` positions
    (each stacked leaf's layer axis resized to a prime, so that the
    reference's search for the batch dim cannot take it for the batch, as
    in ``tests/test_torch_sharding.py``)."""
    shape = _mesh_shape(mesh)
    ref_cfg = ref_registry.ARCHS[arch].smoke
    if window:
        ref_cfg = ref_cfg.replace(attention_window=window)
    cache = jax.tree_util.tree_map_with_path(
        lambda path, x: x if any(str(getattr(k, "key", "")) == "extra" for k in path)
        else jax.ShapeDtypeStruct((10007, *x.shape[1:]), x.dtype),
        jax.eval_shape(lambda: ref_api.init_cache(ref_cfg, batch, ranks.LAYOUT_CACHE)))
    specs = ref_sharding.cache_pspecs(cache, ref_cfg, SimpleNamespace(
        shape=shape, axis_names=tuple(shape)), batch=batch)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("k", "v", "xk", "xv"):
            s_idx = 1 if any(str(getattr(k, "key", "")) == "extra" for k in path) else 2
            entry = tuple(spec)[s_idx] if len(tuple(spec)) > s_idx else None
            out[name] = [] if entry is None else ([entry] if isinstance(entry, str)
                                                  else list(entry))
    return out


@pytest.mark.parametrize("world,arch,mesh,batch,window,train", LAYOUT_CELLS)
def test_layouts_match_one_device_and_the_reference(runs, world, arch, mesh, batch, window,
                                                    train):
    """Heads cut inside and KV sequences cut over "model", "data" or both,
    through the mesh engine: the prefill's and each teacher-forced decode
    step's logits against the single device within ``LOGITS_TOL``, the
    prefill's also against the reference's own ``prefill``; the greedy
    tokens of ``generate`` and ``generate_stream`` equal to the single
    device's; the cache's sequence cuts those of the reference's
    ``cache_pspecs``; one decode step's counted collectives equal to
    ``launch/comms.py``'s plan of the layout."""
    want_cuts = _reference_seq_cuts(arch, mesh, batch, window)
    ref_last = _reference_last_logits(arch, (0, batch), batch, window)
    for res in _result(runs, world, ranks.layout_name(arch, mesh, batch, window)):
        assert res["prefill_rel"] <= LOGITS_TOL and res["decode_rel"] <= LOGITS_TOL, res
        assert res["tokens"] == res["want"] == res["stream"]
        assert res["seq_cuts"] == want_cuts
        got = np.array(res["last"])
        rel = np.linalg.norm(got - ref_last) / np.linalg.norm(ref_last)
        assert rel <= LOGITS_TOL, rel
        counts = {k: tuple(v) for k, v in res["counts"].items()}
        assert counts == {k: tuple(v) for k, v in res["plan"].items()}
        assert counts, "a sharded layout moves something"


@pytest.mark.parametrize("world,arch,mesh,batch,window", [
    cell[:5] for cell in LAYOUT_CELLS if cell[5]])
def test_layout_train_step_matches_one_device(runs, world, arch, mesh, batch, window):
    """One AdamW step of the tensor-parallel layouts (heads cut inside, the
    hybrid's recurrence and whisper under "model"): loss and grad norm
    within ``TRAIN_TOL`` of the single device's, every param within
    ``PARAM_TOL`` but the key biases', whose gradient is zero in exact
    arithmetic (``_torch_ranks.train_check``)."""
    for res in _result(runs, world, f"train {ranks.layout_name(arch, mesh, batch, window)}"):
        assert abs(res["loss"] - res["want_loss"]) <= TRAIN_TOL * abs(res["want_loss"])
        assert abs(res["gnorm"] - res["want_gnorm"]) <= TRAIN_TOL * abs(res["want_gnorm"])
        assert res["param_rel"] <= PARAM_TOL
        cfg = registry.get(arch).smoke
        assert res["key_bias_leaves"] == sum(keys[-2:] == ("wk", "b") for keys in
                                             leaf_paths(api.abstract_params(cfg)))
        assert res["local_moments"] < res["params"]


def _losses(out: str) -> list:
    line = next(x for x in out.splitlines() if x.startswith("[train] losses"))
    return [float(v) for v in line.split()[2:]]


def test_the_train_cli_spawns_its_ranks_and_matches_one_device(capfd):
    """``--data-par 2 --model-par 2`` on the CPU: four gloo ranks, whose
    losses (rank 0 prints them) equal the single-device run's within 1e-5
    relative."""
    args = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu", "--steps", "5"]
    assert train_cli.main(args) == 0
    single = _losses(capfd.readouterr().out)
    assert train_cli.main(args + ["--data-par", "2", "--model-par", "2"]) == 0
    out = capfd.readouterr().out
    assert "mesh data=2 model=2: gloo" in out
    sharded = _losses(out)
    assert len(single) == len(sharded) == 5
    for a, b in zip(sharded, single):
        assert abs(a - b) <= TRAIN_TOL * abs(b)

