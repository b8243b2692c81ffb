"""The port's MoE family (``repro_torch.models.moe`` and the transformer's MoE
branch) and the registry's other transformer configs, against the live
reference on the same weights and inputs, on the CPU: the layer with and
without capacity drops, in one group and in several (the gcd branch), its
load-balance loss, the model's forward, prefill and decode step, the engine
and the continuous server; and, on a card (``pytest -m gpu``), the layer on
the card against the CPU and replayed tokens against the uncaptured path's.

The smoke configs are float32, so the bar is logits within 1e-5 and equal
token streams.  The reference is imported inside fixtures: the card's
machine runs this file's gpu tests without JAX."""
import math
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.attention import flash
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.models import api, common, moe, transformer
from repro_torch.models.convert import from_reference
from repro_torch.serving import graphs
from repro_torch.serving.continuous import ContinuousServer, Request
from repro_torch.serving.engine import InferenceEngine

MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
DENSE_ARCHS = ["mistral-nemo-12b", "qwen2.5-32b", "qwen1.5-110b"]
TOL = 1e-5          # float32 smoke configs, the same algorithm; sums in another order
MAX_CACHE = 64


@pytest.fixture(scope="module")
def ref():
    """The reference's registry, models, engine and server on JAX's CPU
    backend, and the reference weights of every arch here as numpy (one
    draw each, seed 0)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import ARCHS
    from repro.models import api as ref_api
    from repro.models import moe as ref_moe
    from repro.models import transformer as ref_transformer
    from repro.serving import continuous, engine
    trees = {a: jax.tree_util.tree_map(np.asarray, ref_api.init_params(
        jax.random.PRNGKey(0), ARCHS[a].smoke)) for a in MOE_ARCHS + DENSE_ARCHS}
    return SimpleNamespace(jax=jax, jnp=jnp, archs=ARCHS, api=ref_api, moe=ref_moe,
                           transformer=ref_transformer, engine=engine,
                           continuous=continuous, trees=trees)


def _cfg(arch):
    return registry.get(arch).smoke


def _port(ref, arch):
    return from_reference(ref.trees[arch], _cfg(arch), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, size=shape)


# ----------------------------------------------------------------------
# configs and weights
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("group", [1, 2, 7, 32, 400, 4096])
def test_capacity_equals_the_reference(ref, arch, group):
    for which in ("config", "smoke"):
        assert moe.capacity(group, getattr(registry.get(arch), which)) == ref.moe.capacity(
            group, getattr(ref.archs[arch], which))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_has_the_reference_tree(ref, dtype):
    """The seeded draw has the reference's leaves, shapes and dtypes (the
    router float32 in a bfloat16 tree) and its scales: N(0, 1/d) for the
    router, ``wi`` and ``wu``, N(0, 1/f) for ``wd``."""
    cfg = _cfg("granite-moe-3b-a800m").replace(param_dtype=dtype, compute_dtype=dtype,
                                               d_model=256, d_ff=128, num_experts=8)
    ref_cfg = ref.archs["granite-moe-3b-a800m"].smoke.replace(
        param_dtype=dtype, compute_dtype=dtype, d_model=256, d_ff=128, num_experts=8)
    want = ref.jax.eval_shape(lambda: ref.moe.moe_init(ref.jax.random.PRNGKey(0), ref_cfg))
    got = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    flat_want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in
                 ref.jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got) == {"router", "wi", "wu", "wd"} and set(got["router"]) == {"w"}
    flat_got = {"router/w": got["router"]["w"], "wi": got["wi"], "wu": got["wu"],
                "wd": got["wd"]}
    assert set(flat_got) == set(flat_want)
    for name, leaf in flat_want.items():
        assert tuple(flat_got[name].shape) == leaf.shape
        assert str(flat_got[name].dtype).removeprefix("torch.") == str(leaf.dtype)
    for name, fan_in in (("router/w", 256), ("wi", 256), ("wu", 256), ("wd", 128)):
        std = flat_got[name].float().std().item()
        assert abs(std * math.sqrt(fan_in) - 1) < 0.02, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_from_reference_keeps_every_moe_leaf(ref, arch):
    """Every leaf of a bfloat16 MoE tree, bit for bit and in its dtype,
    unstacked per layer; the router stays float32."""
    ref_cfg = ref.archs[arch].smoke.replace(param_dtype="bfloat16",
                                            compute_dtype="bfloat16")
    cfg = _cfg(arch).replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = ref.jax.tree_util.tree_map(np.asarray, ref.api.init_params(
        ref.jax.random.PRNGKey(1), ref_cfg))
    params = from_reference(tree, cfg, "cpu")
    assert common.count_params(params) == sum(a.size for a in ref.jax.tree_util.tree_leaves(tree))
    assert common.param_bytes(params) == sum(a.nbytes for a in ref.jax.tree_util.tree_leaves(tree))
    for i, lp in enumerate(params["layers"]):
        assert set(lp) == {"ln1", "ln2", "attn", "moe"}
        for name in ("wi", "wu", "wd"):
            got, want = lp["moe"][name], tree["layers"]["moe"][name][i]
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        router = lp["moe"]["router"]["w"]
        assert router.dtype == torch.float32
        np.testing.assert_array_equal(router.numpy(), tree["layers"]["moe"]["router"]["w"][i])


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------

def _drops(ref, p, x, cfg, group_size):
    """(token, choice) pairs the reference's dispatch drops: per group, the
    pairs of an expert past its capacity, counted from the router's top-k."""
    jnp = ref.jnp
    t = x.shape[0] * x.shape[1]
    gs = min(t, group_size)
    if t % gs:
        gs = math.gcd(t, gs)
    probs = ref.jax.nn.softmax(jnp.asarray(x.reshape(t // gs, gs, -1)) @ p["router"]["w"])
    _, idx = ref.jax.lax.top_k(probs, cfg.num_experts_per_tok)
    cap = ref.moe.capacity(gs, cfg)
    counts = np.stack([np.bincount(g.ravel(), minlength=cfg.num_experts)
                       for g in np.asarray(idx)])
    return int(np.maximum(counts - cap, 0).sum())


# (batch, seq, group size, capacity factor, distinct token vectors): a case
# drawn from a few distinct vectors routes many tokens alike, so that some
# expert overflows its capacity; a capacity factor of 2 makes C = gs, which
# no expert can overflow (a token picks an expert at most once)
LAYER_CASES = {
    "one group, no drops": (2, 16, 4096, 2.0, None),
    "one group, drops": (2, 16, 4096, 1.25, 1),
    "several groups, gcd": (3, 10, 12, 1.25, 2),       # T=30, gs=gcd(30,12)=6, G=5
    "several groups, even": (4, 8, 8, 1.25, 3),        # T=32, G=4
    "decode, a token a row": (4, 1, 4096, 1.25, 1),    # T=4, C=ceil(4*2*1.25/4)=3
    "several groups, no drops": (3, 10, 12, 2.0, None),
}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_apply_matches_the_reference(ref, arch, case):
    b, s, group, cf, distinct = LAYER_CASES[case]
    ref_cfg = ref.archs[arch].smoke.replace(moe_capacity_factor=cf)
    cfg = _cfg(arch).replace(moe_capacity_factor=cf)
    tree = ref.trees[arch]["layers"]["moe"]
    p_np = ref.jax.tree_util.tree_map(lambda a: np.ascontiguousarray(a[1]), tree)
    p_ref = ref.jax.tree_util.tree_map(ref.jnp.asarray, p_np)
    p = ref.jax.tree_util.tree_map(torch.from_numpy, p_np)
    rng = np.random.default_rng(10 + sorted(LAYER_CASES).index(case))
    x = rng.standard_normal((b * s, cfg.d_model)).astype(np.float32)
    if distinct is not None:
        x = x[rng.integers(0, distinct, size=b * s)]
    x = x.reshape(b, s, cfg.d_model)
    assert (_drops(ref, p_ref, x, ref_cfg, group) > 0) == (distinct is not None)
    want, want_aux = ref.moe.moe_apply(p_ref, ref.jnp.asarray(x), ref_cfg, group_size=group)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg, group_size=group)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    _close(moe._aux_loss(p, torch.from_numpy(x), cfg),
           ref.moe._aux_loss(p_ref, ref.jnp.asarray(x), ref_cfg))
    assert torch.equal(moe.moe_ffn(p, torch.from_numpy(x), cfg, group_size=group), got)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_the_reference(ref, arch):
    tokens = _tokens((2, 12), 4)
    params = _port(ref, arch)
    ref_params = ref.jax.tree_util.tree_map(ref.jnp.asarray, ref.trees[arch])
    want, want_aux = ref.transformer.forward(ref_params, ref.jnp.asarray(tokens, ref.jnp.int32),
                                             ref.archs[arch].smoke)
    got, aux = transformer.forward(params, torch.from_numpy(tokens), _cfg(arch))
    _close(got, want)
    _close(aux, want_aux)
    assert aux.item() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_prefill_and_decode_match_the_reference(ref, arch):
    """The prefill's last logits and cache, then four decode steps (a host
    position, then per-row device positions) with their logits and the
    cache after them."""
    cfg, ref_cfg = _cfg(arch), ref.archs[arch].smoke
    jnp = ref.jnp
    params = _port(ref, arch)
    ref_params = ref.jax.tree_util.tree_map(jnp.asarray, ref.trees[arch])
    tokens = _tokens((3, 9), 5)
    want, ref_cache = ref.api.prefill(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                      ref_cfg, 24)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg, 24)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    step = _tokens((4, 3), 6)
    for i in range(4):
        pos = 9 + i
        want, ref_cache = ref.api.decode_step(ref_params, ref_cache,
                                              jnp.asarray(step[i], jnp.int32),
                                              jnp.int32(pos), ref_cfg)
        port_pos = pos if i < 2 else torch.full((3,), pos)
        got, cache = api.decode_step(params, cache, torch.from_numpy(step[i]), port_pos, cfg)
        _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])


# ----------------------------------------------------------------------
# the engine and the server
# ----------------------------------------------------------------------

def _engines(ref, arch):
    r = ref.engine.InferenceEngine(ref.archs[arch].smoke, seed=0, max_cache=MAX_CACHE)
    r.params = ref.jax.tree_util.tree_map(ref.jnp.asarray, ref.trees[arch])
    return r, InferenceEngine(_cfg(arch), max_cache=MAX_CACHE, params=_port(ref, arch),
                              device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_engine_greedy_tokens_and_shapes_equal_the_reference(ref, arch):
    """Greedy tokens at batch 1, 2 and 4 and prompts of 3 to 13 tokens; the
    prefill shapes (MoE: every exact length at the fixed cache; dense: per
    bucket) and fused decode lengths counted as the reference's jits."""
    ref_eng, eng = _engines(ref, arch)
    for e in (ref_eng, eng):
        e.warmup(2, 6)
    for b, s, n_new in ((1, 5, 6), (2, 7, 9), (4, 13, 5), (1, 3, 6), (2, 8, 9)):
        prompt = _tokens((b, s), 100 * b + s)
        want = np.asarray(ref_eng.generate(ref.jnp.asarray(prompt, ref.jnp.int32),
                                           n_new).tokens)
        np.testing.assert_array_equal(eng.generate(prompt, n_new).tokens.numpy(), want)
        assert eng._prefill_shapes(s, n_new) == ref_eng._prefill_shapes(s, n_new)
    for key in ("prefill", "decode_scan"):
        assert eng.compile_stats()[key] == ref_eng.compile_stats()[key], key
    assert eng.compile_stats()["prefill_graphs"] == eng.compile_stats()["graphs"] == 0


# (requests, slots, max_seq, seed, n_new range)
SERVER_CASES = [(7, 3, 48, 0, (3, 9)), (9, 4, 64, 1, (1, 12)), (5, 2, 24, 2, (6, 20))]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n_req,slots,max_seq,seed,n_new", SERVER_CASES)
def test_continuous_server_equals_the_reference(ref, arch, n_req, slots, max_seq, seed,
                                                n_new):
    """Completions, their order and steps in flight, the server's steps and
    its shape counts (an exact prefill a prompt length, the fused chunks,
    the scatters by rows admitted) equal the live reference's; the last
    case runs out of cache before its budgets."""
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(2, 16))).tolist(),
             int(rng.integers(*n_new))) for i in range(n_req)]
    r = ref.continuous.ContinuousServer(ref.archs[arch].smoke, slots=slots,
                                        max_seq=max_seq, seed=0)
    params = from_reference(ref.jax.tree_util.tree_map(np.asarray, r.params), _cfg(arch),
                            "cpu")
    srv = ContinuousServer(_cfg(arch), slots=slots, max_seq=max_seq, params=params,
                           device="cpu")
    done = []
    for server, cls in ((r, ref.continuous.Request), (srv, Request)):
        for rid, prompt, n in reqs:
            server.submit(cls(rid=rid, prompt=list(prompt), n_new=n))
        done.append([(c.rid, c.tokens, c.steps_in_flight) for c in server.run()])
    assert done[1] == done[0]
    assert srv.steps == r.steps
    stats, want = srv.compile_stats(), r.compile_stats()
    assert {k: stats[k] for k in want} == want
    assert stats["prefill"] == len({len(p) for _, p, _ in reqs})
    assert stats["prefill_graphs"] == stats["graphs"] == 0 and not srv._admissions


def test_exact_admission_through_the_staging_rows_equals_the_reference(ref):
    """granite's smoke config on 3 slots, the first round admitting two
    requests of one length and one of another: each request replays the
    batch-1 graph of its exact length (eager through its buffers on the
    CPU) into its own staging row, so the admitted slots hold each prompt's
    own prefill, and the completions, their order and steps in flight and
    the shape counts equal the live reference's."""
    arch = "granite-moe-3b-a800m"
    cfg = _cfg(arch)
    rng = np.random.default_rng(11)
    reqs = [(i, rng.integers(0, 512, size=n).tolist(), k)
            for i, (n, k) in enumerate([(9, 4), (9, 6), (5, 3), (9, 2), (12, 5), (5, 7)])]
    r = ref.continuous.ContinuousServer(ref.archs[arch].smoke, slots=3, max_seq=48, seed=0)
    params = from_reference(ref.jax.tree_util.tree_map(np.asarray, r.params), cfg, "cpu")
    first = ContinuousServer(cfg, slots=3, max_seq=48, params=params, device="cpu")
    for rid, prompt, n in reqs[:3]:
        first.submit(Request(rid=rid, prompt=list(prompt), n_new=n))
    first.prefill_pending()
    for slot, (_, prompt, _) in enumerate(reqs[:3]):
        _, want = api.prefill(params, {"tokens": torch.tensor([prompt])}, cfg, 48)
        for name in ("k", "v"):
            assert torch.equal(first.cache[name][:, slot], want[name][:, 0])
    assert sorted(first._exact) == [5, 9] and first._exact[9].replays == 2

    srv = ContinuousServer(cfg, slots=3, max_seq=48, params=params, device="cpu")
    done = []
    for server, cls in ((r, ref.continuous.Request), (srv, Request)):
        for rid, prompt, n in reqs:
            server.submit(cls(rid=rid, prompt=list(prompt), n_new=n))
        done.append([(c.rid, c.tokens, c.steps_in_flight) for c in server.run()])
    assert done[1] == done[0]
    assert srv.steps == r.steps
    stats, want = srv.compile_stats(), r.compile_stats()
    assert {k: stats[k] for k in want} == want
    assert sorted(srv._exact) == [5, 9, 12] == sorted({len(p) for _, p, _ in reqs})
    assert sum(g.replays for g in srv._exact.values()) == len(reqs)
    assert stats["prefill_graphs"] == 0 and not srv._admissions


def test_serve_cli_serves_a_moe_arch_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--requests", "5",
                       "--n-new", "3", "--device", "cpu"])
    assert sorted(outs) == list(range(5)) and all(len(t) == 3 for t in outs.values())
    assert "5 requests served (15 tokens)" in capsys.readouterr().out


# ----------------------------------------------------------------------
# on the card: the layer against the CPU, replayed against uncaptured
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _uncaptured():
    return mock.patch.object(graphs.CapturedStep, "capture", lambda self: None)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,group", [((4, 1), 4096), ((4, 100), 4096), ((3, 10), 12)])
def test_moe_layer_on_the_card_equals_the_cpu(cuda, shape, group):
    cfg = _cfg("granite-moe-3b-a800m")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(shape + (cfg.d_model,), generator=torch.Generator().manual_seed(1))
    want = moe.moe_ffn(p, x, cfg, group)
    p_card = {k: ({"w": v["w"].to(cuda)} if k == "router" else v.to(cuda))
              for k, v in p.items()}
    got = moe.moe_ffn(p_card, x.to(cuda), cfg, group)
    torch.testing.assert_close(got.cpu(), want, atol=TOL, rtol=TOL)
    assert torch.equal(moe.moe_ffn(p_card, x.to(cuda), cfg, group), got)   # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_replayed_moe_engine_tokens_equal_the_uncaptured_path(cuda, temperature):
    """The prefill at the exact length and the decode step, captured and
    replayed, give the uncaptured path's tokens; K1 launches once a layer
    for the prefill's capture warm-up and once for its replay, K2 once a
    layer a step."""
    cfg = _cfg("granite-moe-3b-a800m")
    eng = InferenceEngine(cfg, seed=0, max_cache=96, device=cuda)
    prompt = np.random.default_rng(3).integers(0, 512, size=(3, 11))
    with _uncaptured():
        plain = InferenceEngine(cfg, max_cache=96, params=eng.params, device=cuda)
        want = plain.generate(prompt, 70, temperature=temperature, seed=4).tokens
    n1, n2 = flash.launches, fd.launches
    got = eng.generate(prompt, 70, temperature=temperature, seed=4).tokens
    torch.cuda.synchronize()
    assert eng.compile_stats()["graphs"] == eng.compile_stats()["prefill_graphs"] == 1
    assert torch.equal(got, want)
    assert flash.launches - n1 == cfg.num_layers * 2
    assert fd.launches - n2 == cfg.num_layers * (1 + 69)


@pytest.mark.gpu
def test_moe_server_on_the_card_equals_the_uncaptured_one(cuda):
    """Each admission a replay of the batch-1 graph of its exact length (K1
    once a layer a request, once all are captured), the decode step
    replayed (K2 once a layer a step)."""
    cfg = _cfg("granite-moe-3b-a800m")
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(4, 40))).tolist(),
             int(rng.integers(3, 70))) for i in range(8)]
    srv = ContinuousServer(cfg, slots=4, max_seq=128, seed=0, device=cuda)
    plain = ContinuousServer(cfg, slots=4, max_seq=128, params=srv.params, device=cuda)

    def serve(server):
        for rid, prompt, n in reqs:
            server.submit(Request(rid=rid, prompt=prompt, n_new=n))
        return [(c.rid, c.tokens) for c in server.run()]

    with _uncaptured():
        want = serve(plain)
    assert serve(srv) == want
    n1, n2, steps = flash.launches, fd.launches, srv.steps
    assert serve(srv) == want
    assert flash.launches - n1 == cfg.num_layers * len(reqs)
    assert fd.launches - n2 == cfg.num_layers * (srv.steps - steps)
    lengths = {len(p) for _, p, _ in reqs}
    assert srv.compile_stats()["graphs"] == 1
    assert srv.compile_stats()["prefill_graphs"] == len(srv._exact) == len(lengths)
    assert plain.compile_stats()["prefill_graphs"] == 0

