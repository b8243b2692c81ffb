"""The port's sequence parallelism (``shardctx.use_mesh(mesh, seq_parallel=True)``):
the residual stream cut over "model" between blocks, each block's input
gathered along the sequence and its row-parallel output reduce-scattered.

The rank cells run in the spawns of ``tests/test_torch_distributed.py``
(``tests/_torch_ranks.py::seq_parallel``, on (1, 2) in the two-rank spawn and
on (2, 2) in the four-rank one), which run once a session and are shared
with that file (``spawned``).  The oracles: the reference's single-device
``prefill`` (JAX, float32) on the port's seeded weights, the port's single
device, the same mesh without the flag (under gloo the cut layout sums the
same float32 partials, so its logits and cache are the flag-less run's bit
for bit), and ``launch/comms.py``'s plans of a prefill and of a train step.
"""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import api as ref_api
from repro_torch import shardctx
from repro_torch.configs import registry
from repro_torch.launch import comms, sharding, steps
from repro_torch.models import api, convert
from repro_torch.models.common import leaf_paths
from repro_torch.train.optimizer import AdamW

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ranks as ranks  # noqa: E402
from test_torch_distributed import spawned  # noqa: E402

TOL = 1e-5              # logits, cache, loss, grad norm, params: relative
PARAM_TOL = 1e-4        # whisper's params after a step against one device (both layouts)
MESHES = (("2", "1x2"), ("4", "2x2"))
PREFILL = [(arch, world, mesh) for arch in ranks.SEQ_ARCHS for world, mesh in MESHES]
TRAIN = [(arch, world, mesh) for arch in ranks.SEQ_TRAIN for world, mesh in MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawned(tmp_path_factory)


def _result(runs, world: str, name: str) -> list:
    got = [r[name] for r in runs[world]]
    for r, g in enumerate(got):
        assert not (isinstance(g, dict) and "error" in g), f"rank {r}: {g.get('traceback')}"
    return got


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _kinds(counts: dict) -> dict:
    return {k: tuple(v) for k, v in counts.items()}


def _minus(a: dict, b: dict) -> dict:
    """Count and bytes of ``a`` less ``b``, kind by kind (zeros dropped)."""
    out = {}
    for k in set(a) | set(b):
        n = a.get(k, (0, 0.0))[0] - b.get(k, (0, 0.0))[0]
        nbytes = a.get(k, (0, 0.0))[1] - b.get(k, (0, 0.0))[1]
        if n or nbytes:
            out[k] = (n, nbytes)
    return out


_REF: dict = {}


def _reference(arch: str, rows: tuple, s: int = 8, vocab: int = 0):
    """The reference's single-device ``prefill`` of rows ``rows`` of the
    ranks' prompts of ``s`` text tokens (``ranks.seq_inputs``) on the
    port's seeded weights: (the last position's logits, {cache leaf path:
    array})."""
    key = (arch, rows, s, vocab)
    if key not in _REF:
        cfg = ranks._smoke(arch, vocab=vocab)
        ref_cfg = ref_registry.ARCHS[arch].smoke
        if vocab:
            ref_cfg = ref_cfg.replace(vocab_size=vocab)
        params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                                        convert.to_reference(ranks._params(cfg), cfg))
        inputs = {k: jnp.asarray(v.numpy()[slice(*rows)])
                  for k, v in ranks.seq_inputs(cfg, ranks._prompts(cfg, 4, s)).items()}
        logits, cache = ref_api.prefill(params, inputs, ref_cfg)
        leaves = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                  np.asarray(x) for path, x in jax.tree_util.tree_flatten_with_path(cache)[0]}
        _REF[key] = (np.asarray(logits), leaves)
    return _REF[key]


def _check_reference(res, arch: str, vocab: int = 0) -> None:
    """A rank's cut prefill against the reference: its rows' last logits,
    and every cache leaf (the whole batch's, or a MoE data rank's rows)."""
    lo, hi = res["rows"]
    rows = (lo, hi) if res["per_shard"] else (0, 4)
    want, cache = _reference(arch, rows, res["text"], vocab)
    if not res["per_shard"]:
        want = want[lo:hi]
    assert _rel(res["last"], want) <= TOL
    cfg = ranks._smoke(arch, vocab=vocab)
    paths = [tuple(map(str, p)) for p in leaf_paths(api.init_cache(cfg, 4, res["seq"],
                                                                    device="meta"))]
    for path, got in zip(paths, res["cache"]):
        ref = cache[path]
        if res["per_shard"]:    # a data rank's rows, on the cache's batch dim 1
            got = np.asarray(got)[:, lo:hi]
        if np.abs(ref).max() > 0:
            assert _rel(got, ref) <= TOL, path
        else:
            assert np.abs(np.asarray(got)).max() == 0, path


@pytest.mark.parametrize("arch,world,mesh", PREFILL)
def test_cut_prefill_matches_one_device_and_the_flagless_mesh(runs, arch, world, mesh):
    """Logits and the whole cache within 1e-5 of the single device, and bit
    for bit the same mesh's prefill without the flag."""
    for res in _result(runs, world, f"sp {arch} {mesh}"):
        assert res["logits_rel"] <= TOL and res["cache_rel"] <= TOL
        assert res["logits_equal_tp"] and res["cache_equal_tp"]


@pytest.mark.parametrize("arch,world,mesh", PREFILL)
def test_cut_prefill_matches_the_reference_prefill(runs, arch, world, mesh):
    for res in _result(runs, world, f"sp {arch} {mesh}"):
        _check_reference(res, arch)


@pytest.mark.parametrize("arch,world,mesh", PREFILL)
def test_cut_prefill_collectives_equal_the_plan(runs, arch, world, mesh):
    """The cut prefill's collectives, kind by kind, equal ``comms.prefill``'s
    plan with the flag, the flag-less run's the plan without it; the cut
    moves reduce-scatters where the flag-less run all-reduces."""
    for res in _result(runs, world, f"sp {arch} {mesh}"):
        assert _kinds(res["counts"]) == _kinds(res["plan"])
        assert _kinds(res["tp_counts"]) == _kinds(res["tp_plan"])
        assert res["counts"]["reduce-scatter"][0] > 0
        assert res["counts"] != res["tp_counts"]


@pytest.mark.parametrize("arch,world,mesh", PREFILL)
def test_a_length_that_does_not_divide_runs_uncut(runs, arch, world, mesh):
    """A prompt of 7 tokens (the vlm's 15 positions) does not divide the
    model axis: the reference's rule leaves the stream whole, so the run
    counts exactly what it counts without the flag, with the same logits.
    Whisper's 16 frames still divide it, so its encoder alone is cut."""
    for res in _result(runs, world, f"sp {arch} {mesh} s7"):
        assert res["logits_equal_tp"] and res["cache_equal_tp"]
        assert res["logits_rel"] <= TOL and res["cache_rel"] <= TOL
        assert _kinds(res["counts"]) == _kinds(res["plan"])
        if arch == "whisper-tiny":
            assert res["counts"] != res["tp_counts"]
        else:
            assert res["counts"] == res["tp_counts"]
        _check_reference(res, arch)


@pytest.mark.parametrize("world,mesh", MESHES)
def test_whole_vocabulary_tables_under_the_cut(runs, world, mesh):
    """whisper with a vocabulary of 511, which no model axis over 1
    divides: the tied table stays whole on every rank (its lookup cut to
    the chunk, the chunks gathered before its product), the prefill and
    one AdamW step match one device and the flag-less mesh."""
    for res in _result(runs, world, f"sp whisper-tiny {mesh} v511"):
        assert res["logits_equal_tp"] and res["cache_equal_tp"]
        assert _kinds(res["counts"]) == _kinds(res["plan"])
        _check_reference(res, "whisper-tiny", 511)
    for res in _result(runs, world, f"sp train whisper-tiny {mesh} v511"):
        assert abs(res["loss"] - res["want_loss"]) <= TOL * abs(res["want_loss"])
        assert abs(res["gnorm"] - res["want_gnorm"]) <= TOL * abs(res["want_gnorm"])
        assert res["param_rel"] <= PARAM_TOL and res["tp_param_rel"] <= TOL


def _train_plan_delta(arch: str, mesh: str, vocab: int = 0) -> dict:
    cfg = ranks._smoke(arch, vocab=vocab)
    if cfg.is_moe and mesh == "2x2":
        cfg = cfg.replace(router_aux_weight=0.0)
    d, m = map(int, mesh.split("x"))
    plans = [comms.train_step(cfg, {"data": d, "model": m}, batch=4, seq=16, seq_parallel=f)
             for f in (True, False)]
    return plans


@pytest.mark.parametrize("arch,world,mesh", TRAIN)
def test_cut_train_step_matches_one_device(runs, arch, world, mesh):
    """One AdamW step with the cut: loss, grad norm and every param (the
    norms' weights and the biases added after a reduce-scatter included,
    which a gradient left partial over "model" would miss) within 1e-5 of
    one device's step and of the flag-less mesh's.  Its collectives beyond
    the flag-less step's are the train plans' difference; on (1, 2), with
    no data axis, they are the plan and the grad norm's all-reduce."""
    sp, tp = _train_plan_delta(arch, mesh)
    for res in _result(runs, world, f"sp train {arch} {mesh}"):
        assert abs(res["loss"] - res["want_loss"]) <= TOL * abs(res["want_loss"])
        assert abs(res["gnorm"] - res["want_gnorm"]) <= TOL * abs(res["want_gnorm"])
        assert res["param_rel"] <= TOL and res["tp_param_rel"] <= TOL
        got = _kinds(res["counts"])
        assert _minus(got, _kinds(res["tp_counts"])) == _minus(sp, tp)
        if mesh == "1x2":
            assert _minus(got, sp) == {"all-reduce": (1, 4.0)}


# ----------------------------------------------------------------------
# the flag and the plan, without ranks
# ----------------------------------------------------------------------

def _mesh(model: int, data: int = 1):
    return SimpleNamespace(axis_names=("data", "model"), shape={"data": data, "model": model})


@pytest.mark.parametrize("flag,model,length,want", [
    (True, 2, 8, True), (True, 2, 7, False), (True, 1, 8, False), (False, 2, 8, False),
    (True, 16, 32768, True), (True, 16, 1500, False), (True, 4, 1500, True),
    (True, 16, 1, False)])
def test_seq_cut_is_the_references_rule(flag, model, length, want):
    """A mesh, the flag, a "model" axis over 1, and a whole length that
    divides it (a decode step's 1 never does; whisper's 1500 frames divide
    4, not 16)."""
    with shardctx.use_mesh(_mesh(model), seq_parallel=flag):
        assert shardctx.seq_parallel() == flag
        assert shardctx.seq_cut(torch.empty((2, length), device="meta"), 1) == want
    assert not shardctx.seq_parallel() and shardctx.get_mesh() is None
    assert not shardctx.seq_cut(torch.empty((2, 8), device="meta"), 1)


def test_use_mesh_restores_the_flag_it_found():
    with shardctx.use_mesh(_mesh(2), seq_parallel=True):
        with shardctx.use_mesh(_mesh(4)):
            assert not shardctx.seq_parallel()
        assert shardctx.seq_parallel() and shardctx.get_mesh().shape["model"] == 2
    assert not shardctx.seq_parallel()


def test_the_steps_keep_the_ambient_flag(monkeypatch):
    """``make_prefill_step``, ``make_serve_step`` and the sharded train step
    re-install their mesh with the flag they are called under, so that a
    caller's ``use_mesh(mesh, seq_parallel=True)`` reaches the model."""
    seen = []

    def record(*a, **k):
        seen.append(shardctx.seq_parallel())
        raise StopIteration

    monkeypatch.setattr(api, "prefill", record)
    monkeypatch.setattr(api, "decode_step", record)
    monkeypatch.setattr(api, "train_loss", record)
    cfg = registry.get("deepseek-7b").smoke
    mesh = comms._fake_mesh({"data": 1, "model": 2}, 0)
    specs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    cache = api.init_cache(cfg, 2, 8, device="meta")
    cache_sp = sharding.cache_pspecs(cache, cfg, mesh, batch=2)
    prefill = steps.make_prefill_step(cfg, mesh=mesh, param_pspecs=specs, cache_pspecs=cache_sp)
    serve = steps.make_serve_step(cfg, mesh=mesh, param_pspecs=specs, cache_pspecs=cache_sp)
    train = steps.make_train_step(cfg, AdamW(), mesh=mesh, param_pspecs=specs)
    tokens = torch.zeros((2, 8), dtype=torch.long)
    for flag in (True, False):
        with shardctx.use_mesh(mesh, seq_parallel=flag):
            for call in (lambda: prefill({}, {"tokens": tokens}, cache),
                         lambda: serve({}, cache, tokens[:, 0], 3),
                         lambda: train({}, {}, {"tokens": tokens, "labels": tokens})):
                with pytest.raises(StopIteration):
                    call()
    assert seen == [True] * 3 + [False] * 3


def test_dense_bf16_layer_moves_three_quarters_of_the_link_bytes():
    """deepseek-7b's prefill_32k on a rank of (16, 16): a layer's two
    row-cut all-reduces of float32 (b, s, d) become reduce-scatters plus two
    gathers of the bf16 normed input: 0.75 of the bytes in twice the
    collectives; the embedding's all-reduce halves, one gather of the
    stream is added, and the logits' gather stays."""
    cfg = registry.get("deepseek-7b").config
    mesh = {"data": 16, "model": 16}

    def plan(layers, flag):
        return comms.prefill(cfg.replace(num_layers=layers), mesh, batch=32, seq=32768,
                             seq_parallel=flag)

    def layer(flag):
        return _minus(plan(2, flag), plan(1, flag))

    tp, sp = layer(False), layer(True)
    b, s, d = 2, 32768, 4096
    ring = 15 / 16
    assert tp == {"all-reduce": (2, 2 * 2 * 4 * b * s * d * ring)}
    assert sp == {"reduce-scatter": (2, 2 * 4 * b * s * d * ring),
                  "all-gather": (2, 2 * 2 * b * s * d * ring)}
    assert sum(v[1] for v in sp.values()) / sum(v[1] for v in tp.values()) == 0.75
    whole_tp, whole_sp = plan(30, False), plan(30, True)
    assert whole_tp["all-reduce"] == (61, 61 * 8 * b * s * d * ring)
    assert whole_sp["reduce-scatter"] == (61, 61 * 4 * b * s * d * ring)
    assert whole_sp["all-gather"] == (62, 61 * 2 * b * s * d * ring + 4 * b * 102400 * ring)
    assert whole_tp["all-gather"] == (1, 4 * b * 102400 * ring)


@pytest.mark.parametrize("arch", ["deepseek-7b", "rwkv6-1.6b", "whisper-tiny"])
def test_a_decode_step_plan_has_no_cut(arch):
    """A decode step's length of 1 never divides the model axis: the cut
    prefill plan at one position is the flag-less one."""
    cfg = registry.get(arch).config
    for flag in (True, False):
        with shardctx.use_mesh(_mesh(16, 16), seq_parallel=flag):
            assert not shardctx.seq_cut(torch.empty((128, 1), device="meta"), 1)
    assert comms.prefill(cfg, {"data": 16, "model": 16}, batch=128, seq=1,
                         seq_parallel=True) == comms.prefill(
        cfg, {"data": 16, "model": 16}, batch=128, seq=1)


def test_train_plan_counts_the_recompute_and_the_adjoints():
    """deepseek's smoke train step on (1, 2): every layer's forward twice
    under remat but its last reduce-scatter once (torch's checkpoint stops
    its recompute once the saved tensors are back), each gather's adjoint a
    reduce-scatter and each reduce-scatter's an all-gather, and one
    all-reduce over "model" of each of the five norm weights."""
    cfg = registry.get("deepseek-7b").smoke
    plan = comms.train_step(cfg, {"data": 1, "model": 2}, batch=4, seq=16, seq_parallel=True)
    bsd = 4 * 16 * cfg.d_model / 2
    # per layer: 2 gathers twice, their 2 adjoints; 2 reduce-scatters, 3 runs, 2 adjoints
    assert plan["all-gather"][0] == 2 * (2 * 2 + 2) + 1 + 1 + 1
    assert plan["reduce-scatter"][0] == 2 * (3 + 2) + 1 + 1
    assert plan["all-reduce"] == (5, 5 * 2 * cfg.d_model * 4 / 2)
    assert plan["reduce-scatter"][1] == 2 * (3 * 4 + 2 * 4) * bsd + 4 * bsd + 4 * bsd
