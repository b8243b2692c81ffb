"""The port's hybrid family (RecurrentGemma, ``models/hybrid.py``) against
the reference package on the same weights and tokens, on the CPU: the smoke
config (float32, window 8), and a 5-layer variant of it (one pattern unit and
the 2-layer remainder stack).

The reference's init sets each recurrent block's ``conv_b`` and the
``wa``/``wx`` biases to zero and ``lam`` to the constant 2.0, which would
hide a slip per channel (a bias or decay applied to the wrong channel gives
the same numbers), so every parity test draws them anew and hands the same
arrays to both sides.  Logits and states are held within 1e-5, token
streams exactly; the log-depth scan equals ``jax.lax.associative_scan`` bit
for bit (but for the subnormals that XLA flushes to zero)."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import hybrid as ref_hybrid
from repro.serving import engine as ref_engine
from repro_torch.configs import recurrentgemma_9b
from repro_torch.core import calibration
from repro_torch.models import api, common, hybrid, layers
from repro_torch.models.convert import from_reference
from repro_torch.serving.continuous import ContinuousServer
from repro_torch.serving.engine import InferenceEngine

REF_CFG = ARCHS["recurrentgemma-9b"].smoke
CFG = recurrentgemma_9b.SMOKE
TOL = 1e-5   # float32, same algorithm; sums in another order
WIN = CFG.attention_window
DEPTHS = (3, 5)   # one unit; one unit and the remainder (rglru, rglru)


def _redrawn_tree(ref_cfg, seed=0):
    """The reference's init as numpy, with ``conv_b`` and every ``b`` (the
    ``wa``/``wx`` biases, the only biases of this config) from N(0, 0.1) and
    ``lam`` from N(2, 0.5), per channel."""
    tree = jax.tree_util.tree_map(np.array, ref_api.init_params(jax.random.PRNGKey(seed),
                                                                ref_cfg))
    rng = np.random.default_rng(seed + 100)
    draw = {"conv_b": (0.0, 0.1), "b": (0.0, 0.1), "lam": (2.0, 0.5)}

    def walk(t):
        if isinstance(t, list):
            return [walk(x) for x in t]
        if not isinstance(t, dict):
            return t
        return {k: (rng.normal(*draw[k], v.shape).astype(v.dtype) if k in draw else walk(v))
                for k, v in t.items()}
    return walk(tree)


@pytest.fixture(scope="module")
def models():
    """depth -> (reference cfg, port cfg, reference params, port params)."""
    out = {}
    for n in DEPTHS:
        ref_cfg, cfg = REF_CFG.replace(num_layers=n), CFG.replace(num_layers=n)
        tree = _redrawn_tree(ref_cfg)
        out[n] = (ref_cfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                  from_reference(tree, cfg, "cpu"))
    return out


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _leaves(tree):
    """Every array of a state, in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _close_state(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        _close(a, b)


# ----------------------------------------------------------------------
# init, the cache layout and the weights bridge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", DEPTHS)
def test_convert_maps_units_and_extra(models, n):
    ref_cfg, cfg, ref_params, params = models[n]
    n_units = n // len(cfg.pattern)
    assert len(params["units"]) == n_units and len(params["extra"]) == n - 3 * n_units
    assert common.count_params(params) == ref_common.count_params(ref_params)
    for u, unit in enumerate(params["units"]):
        assert sorted(unit) == ["b0", "b1", "b2"]
        np.testing.assert_array_equal(unit["b1"]["rec"]["lam"].numpy(),
                                      np.asarray(ref_params["units"]["b1"]["rec"]["lam"][u]))
        np.testing.assert_array_equal(unit["b2"]["attn"]["wq"]["w"].numpy(),
                                      np.asarray(ref_params["units"]["b2"]["attn"]["wq"]["w"][u]))
    for j, block in enumerate(params["extra"]):
        np.testing.assert_array_equal(block["rec"]["conv_b"].numpy(),
                                      np.asarray(ref_params["extra"][j]["rec"]["conv_b"]))


@pytest.mark.parametrize("n", DEPTHS)
def test_seeded_init_has_the_reference_tree(n):
    ref_cfg, cfg = REF_CFG.replace(num_layers=n), CFG.replace(num_layers=n)
    want = jax.eval_shape(lambda: ref_api.init_params(jax.random.PRNGKey(0), ref_cfg))
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    unit = jax.tree_util.tree_map(lambda x: x.shape[1:], want["units"])
    for got in params["units"]:
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == unit
    assert [jax.tree_util.tree_map(lambda t: tuple(t.shape), b) for b in params["extra"]] == \
        [jax.tree_util.tree_map(lambda x: x.shape, b) for b in want["extra"]]
    assert common.count_params(params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))
    assert params["units"][0]["b0"]["rec"]["lam"].dtype == torch.float32


@pytest.mark.parametrize("n", DEPTHS)
def test_init_cache_has_the_reference_layout(n):
    ref_cfg, cfg = REF_CFG.replace(num_layers=n), CFG.replace(num_layers=n)
    want = ref_hybrid.init_cache(ref_cfg, 3)
    got = api.init_cache(cfg, 3, 0, device="cpu")
    assert sorted(got) == ["extra", "units"] and len(got["extra"]) == len(want["extra"])
    _close_state(got, want)
    assert hybrid.cache_batch(got) == 3
    assert got["units"]["b0"]["lru"].dtype == torch.float32
    bf16 = api.init_cache(cfg.replace(compute_dtype="bfloat16"), 3, 0, device="cpu")
    assert bf16["units"]["b0"]["lru"].dtype == torch.float32        # the state stays f32
    assert bf16["units"]["b2"]["k"].dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the RG-LRU block
# ----------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 5, 8, 13, 100, 3072])
def test_scan_equals_associative_scan_bit_for_bit(t):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.05, 1.0, (2, t, 16)).astype(np.float32)
    b = rng.standard_normal((2, t, 16)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ga, gb = hybrid._scan(torch.from_numpy(a), torch.from_numpy(b))
    tiny = np.finfo(np.float32).tiny
    for got, want in ((ga.numpy(), np.asarray(wa)), (gb.numpy(), np.asarray(wb))):
        # XLA's CPU backend flushes subnormal results to zero (a long product
        # of decays underflows), torch keeps them: equal bits elsewhere
        normal = np.abs(want) >= tiny
        np.testing.assert_array_equal(got[normal], want[normal])
        assert np.all(np.abs(got[~normal]) < tiny)


def _rec_params(models):
    ref_cfg, cfg, ref_params, params = models[3]
    ref_p = jax.tree_util.tree_map(lambda x: x[0], ref_params["units"]["b0"]["rec"])
    return ref_cfg, cfg, ref_p, params["units"][0]["b0"]["rec"]


@pytest.mark.parametrize("t", [1, 3, 12])
def test_causal_conv_matches(models, t):
    _, cfg, ref_p, p = _rec_params(models)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, cfg.rglru_conv_width - 1, cfg.d_model)).astype(np.float32)
    want = ref_hybrid._causal_conv(ref_p["conv_w"], ref_p["conv_b"], jnp.asarray(x),
                                   jnp.asarray(state))
    got = hybrid._causal_conv(p["conv_w"], p["conv_b"], torch.from_numpy(x),
                              torch.from_numpy(state))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("t", [1, 7, 40])
def test_rglru_and_its_step_match(models, t):
    _, cfg, ref_p, p = _rec_params(models)
    rng = np.random.default_rng(t + 1)
    x = rng.standard_normal((3, t, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    want_y, want_h = ref_hybrid._rglru(ref_p, jnp.asarray(x), jnp.asarray(h0))
    got_y, got_h = hybrid._rglru(p, torch.from_numpy(x), torch.from_numpy(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)
    want_y, want_h = ref_hybrid._rglru_step(ref_p, jnp.asarray(x[:, :1]), jnp.asarray(h0))
    got_y, got_h = hybrid._rglru_step(p, torch.from_numpy(x[:, :1]), torch.from_numpy(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)


# ----------------------------------------------------------------------
# the model: forward, prefill, the ring buffer and decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("s", [5, WIN, 12])      # short of, at, and past the window
def test_forward_logits_and_state_match(models, n, s):
    ref_cfg, cfg, ref_params, params = models[n]
    toks = _tokens((2, s), s)
    want, ref_state = ref_hybrid.forward(ref_params, jnp.asarray(toks), ref_cfg,
                                         return_state=True)
    got, state = hybrid.forward(params, torch.from_numpy(toks), cfg, return_state=True)
    _close(got, want)
    _close_state(state, ref_state)


@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("s", [5, 12])
def test_prefill_last_logits_and_state_match(models, n, s):
    ref_cfg, cfg, ref_params, params = models[n]
    toks = _tokens((3, s), 20 + s)
    want, ref_state = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg, 32)
    got, state = api.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg, 32)
    _close(got, want)
    _close_state(state, ref_state)


def test_ring_buffer_holds_position_p_at_slot_p_mod_window(models):
    """After a 12-token prompt (window 8) slot p % 8 holds position p's key
    for p in 4..11; after a 5-token prompt slots 0..4 hold positions 0..4
    and the rest is zero."""
    _, cfg, _, params = models[3]
    qkv, keys = hybrid._qkv, []

    def spy(*args):
        out = qkv(*args)
        keys.append(out[1])
        return out

    for s, live in ((12, range(4, 12)), (5, range(5))):
        keys.clear()
        with mock.patch.object(hybrid, "_qkv", spy):
            _, state = api.prefill(params, {"tokens": torch.from_numpy(_tokens((1, s), s))},
                                   cfg)
        (k,) = keys                                    # the one attention layer's
        ring = state["units"]["b2"]["k"][0]
        for p_ in live:
            assert torch.equal(ring[:, p_ % WIN], k[:, p_])
        if s < WIN:
            assert not ring[:, s:].any()


# The reference's RoPE inside its compiled stack computes sin and cos with
# XLA's fused approximations, which at angles near 3000 rad differ from the
# exact ones by up to about 2.3e-4 (``test_rope_at_long_positions``); the
# port's rope is exact there.  So at S = 3072 the roped keys the ring holds
# are held to this bar, and everything else to TOL.
LONG_ROPE_TOL = 1e-3


def test_rope_at_long_positions_equals_the_references_exact_rope():
    x = np.random.default_rng(0).standard_normal((1, 3072, 1, 64)).astype(np.float32)
    pos = np.arange(3072)[None]
    exact = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), CFG.rope_theta)
    fused = jax.jit(lambda a, p: ref_common.apply_rope(a, p, CFG.rope_theta))(
        jnp.asarray(x), jnp.asarray(pos))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), CFG.rope_theta)
    _close(got, exact, tol=1e-6)
    assert np.abs(np.asarray(fused) - np.asarray(exact)).max() < LONG_ROPE_TOL


def test_long_prompt_takes_the_chunked_attention_and_matches(models):
    """S = 3072 > 2048 and a multiple of 1024: the reference's chunked,
    windowed attention branch, on both sides; the ring wraps."""
    ref_cfg, cfg, ref_params, params = models[5]
    toks = _tokens((1, 3072), 3)
    want, ref_state = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg)
    with mock.patch.object(hybrid, "attention_chunked",
                           wraps=layers.attention_chunked) as chunked:
        got, state = api.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert chunked.call_count == 1                     # the one attention layer
    _close(got, want)
    ring, ref_ring = state["units"]["b2"], ref_state["units"]["b2"]
    _close(ring["k"], ref_ring["k"], tol=LONG_ROPE_TOL)
    _close(ring["v"], ref_ring["v"])
    _close_state({"units": {b: state["units"][b] for b in ("b0", "b1")},
                  "extra": state["extra"]},
                 {"units": {b: ref_state["units"][b] for b in ("b0", "b1")},
                  "extra": ref_state["extra"]})


@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("form", ["int", "rows"])
def test_decode_steps_match(models, n, form):
    """Several steps from a 6-token prompt: the ring fills (window 8) and
    wraps; a host int or a (B,) device tensor of equal positions against the
    reference's scalar."""
    ref_cfg, cfg, ref_params, params = models[n]
    toks = _tokens((2, 6), 30)
    _, ref_state = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg)
    _, state = api.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg)
    nxt = _tokens((2,), 31)
    for pos in range(6, 16):
        want, ref_state = ref_api.decode_step(ref_params, ref_state, jnp.asarray(nxt),
                                              jnp.int32(pos), ref_cfg)
        tp = pos if form == "int" else torch.tensor([pos, pos])
        got, state = api.decode_step(params, state, torch.from_numpy(nxt), tp, cfg)
        _close(got, want)
        _close_state(state, ref_state)
        nxt = np.array(jnp.argmax(want, -1))


def _cat_states(a, b):
    """Two batch-1 states as one of batch 2 (units on axis 1, extra on 0)."""
    return {"units": {blk: {k: torch.cat([a["units"][blk][k], b["units"][blk][k]], dim=1)
                            for k in a["units"][blk]} for blk in a["units"]},
            "extra": [{k: torch.cat([x[k], y[k]], dim=0) for k in x}
                      for x, y in zip(a["extra"], b["extra"])]}


def test_decode_per_row_positions_match_each_row_alone(models):
    """Rows at different positions (one short of the window, one past it)
    in one step: each row equals the reference decoding it alone."""
    ref_cfg, cfg, ref_params, params = models[5]
    prompts = [_tokens((1, 5), 40), _tokens((1, 11), 41)]
    ref_states, states = [], []
    for p_ in prompts:
        ref_states.append(ref_api.prefill(ref_params, {"tokens": jnp.asarray(p_)}, ref_cfg)[1])
        states.append(api.prefill(params, {"tokens": torch.from_numpy(p_)}, cfg)[1])
    state = _cat_states(*states)
    pos = np.array([5, 11])
    nxt = _tokens((2,), 42)
    for _ in range(4):
        got, state = api.decode_step(params, state, torch.from_numpy(nxt), torch.from_numpy(pos),
                                     cfg)
        for r in range(2):
            want, ref_states[r] = ref_api.decode_step(ref_params, ref_states[r],
                                                      jnp.asarray(nxt[r:r + 1]),
                                                      jnp.int32(pos[r]), ref_cfg)
            _close(got[r:r + 1], want)
        nxt, pos = got.argmax(-1).numpy(), pos + 1


def test_prefill_resets_a_preallocated_state(models):
    _, cfg, _, params = models[5]
    toks = torch.from_numpy(_tokens((2, 7), 50))
    want, fresh = api.prefill(params, {"tokens": toks}, cfg)
    cache = api.init_cache(cfg, 2, 0, device="cpu")
    for t in common.tensor_leaves(cache):
        t.fill_(7.0)
    got, same = api.prefill(params, {"tokens": toks}, cfg, cache=cache)
    assert same is cache and torch.equal(got, want)
    for a, b in zip(common.tensor_leaves(cache), common.tensor_leaves(fresh)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rows"):
        api.prefill(params, {"tokens": toks[:1]}, cfg, cache=cache)


def test_prefill_refuses_a_last_position(models):
    _, cfg, _, params = models[3]
    with pytest.raises(ValueError, match="exact-length"):
        api.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cfg,
                    last_pos=2)


# ----------------------------------------------------------------------
# the engine against the live reference engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(models):
    """(reference engine, port engine) on the same redrawn 5-layer weights;
    the reference's jits take the params as an argument."""
    ref_cfg, cfg, ref_params, params = models[5]
    ref = ref_engine.InferenceEngine(ref_cfg, seed=0, max_cache=48)
    ref.params = ref_params
    return ref, InferenceEngine(cfg, max_cache=48, params=params, device="cpu")


@pytest.mark.parametrize("prompt,n_new", [
    ([[3, 1, 4, 1, 5]], 6),                                   # short of the window
    ([[7, 7, 2, 9, 1, 4, 4, 8, 3, 2, 6], [5, 0, 3, 3, 8, 1, 1, 9, 40, 2, 7]], 20),
    ([[11, 2, 40, 9, 3, 3, 1, 8]], 70),                       # past one token block
])
def test_engine_greedy_tokens_and_shapes_equal_reference(engines, prompt, n_new):
    ref, eng = engines
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), n_new).tokens)
    got = eng.generate(np.asarray(prompt), n_new).tokens
    np.testing.assert_array_equal(got.numpy(), want)
    stream = eng.generate_stream(np.asarray(prompt), n_new).tokens
    np.testing.assert_array_equal(stream.numpy(), want)
    stats, ref_stats = eng.compile_stats(), ref.compile_stats()
    assert stats["prefill"] == ref_stats["prefill"] and stats["graphs"] == 0
    assert eng._prefill_shapes(11, 20) == ref._prefill_shapes(11, 20)


def test_sampled_engine_is_seeded(engines):
    _, eng = engines
    prompt = np.asarray([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]])
    a = eng.generate(prompt, 12, temperature=0.9, seed=5).tokens
    assert torch.equal(a, eng.generate_stream(prompt, 12, temperature=0.9, seed=5).tokens)
    assert not torch.equal(a, eng.generate(prompt, 12, temperature=0.9, seed=6).tokens)


def test_engine_keeps_the_batch_beside_its_nested_state(models):
    """The state's leaves hold the batch on different axes; the engine keeps
    the batch itself, and a new batch makes a new state and drops the
    steps captured on the old one."""
    _, cfg, _, params = models[5]
    eng = InferenceEngine(cfg, max_cache=32, params=params, device="cpu")
    eng.generate([[1, 2, 3]], 3)
    state = eng._cache
    assert eng._batch == 1 and hybrid.cache_batch(state) == 1
    eng.generate([[4, 5, 6, 7]], 3)
    assert eng._cache is state
    eng.generate([[1, 2, 3], [4, 5, 6]], 3)
    assert eng._cache is not state and eng._batch == 2 == hybrid.cache_batch(eng._cache)
    assert set(eng._prefills) == {(2, 3)}


def test_engine_warmup_and_stats(models):
    _, cfg, ref_params, params = models[5]
    eng = InferenceEngine(cfg, max_cache=32, params=params, device="cpu")
    assert eng.warmup(2, 8) >= 0 and eng.compiled
    assert eng.stats()["params"] == ref_common.count_params(ref_params)


def test_continuous_server_refuses_the_hybrid_family():
    with pytest.raises(ValueError, match="KV-cache layout"):
        ContinuousServer(CFG, slots=2, max_seq=16, device="cpu")


def test_calibration_takes_no_batch_curve_as_the_reference():
    from repro.core import calibration as ref_calibration
    want = ref_calibration.measure_model("recurrentgemma-9b", repeats=1)
    got = calibration.measure_model("recurrentgemma-9b", smoke=True, device="cpu", repeats=1)
    assert got["batch_curve"] == want["batch_curve"] == []
    assert set(got) == set(want) and got["kind"] == "llm" and got["warm_exec_s"] > 0


def test_serve_cli_serves_every_request_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--requests", "5",
                       "--n-new", "3", "--device", "cpu"])
    assert sorted(outs) == list(range(5)) and all(len(t) == 3 for t in outs.values())
    assert "recurrentgemma-smoke on cpu" in capsys.readouterr().out


def test_config_spec_equals_the_reference():
    spec, ref_spec = recurrentgemma_9b.SPEC, ARCHS["recurrentgemma-9b"]
    assert dataclasses.asdict(spec.config) == dataclasses.asdict(ref_spec.config)
    assert hybrid._split_layers(spec.config) == ref_hybrid._split_layers(ref_spec.config)
    assert hybrid._split_layers(spec.config)[1:] == (12, ("rglru", "rglru"))
