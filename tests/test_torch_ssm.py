"""The port's RWKV-6 serving path (rwkv6 smoke config, float32) against the
reference package on the same weights and tokens, on the CPU.

The reference initialises each layer's time-mix output projection ``wo`` to
zero, so with its own weights the whole WKV branch (ddlerp, r/k/v/g, decay,
the recurrence, the group norm) adds nothing to the logits.  Every parity
test here therefore draws ``tmix.wo.w`` (and ``tmix.decay_w2``, so that the
decay LoRA matters) anew, non-zero, and hands the same arrays to both sides,
and compares the recurrent state itself besides the logits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import ssm as ref_ssm
from repro.serving import engine as ref_engine
from repro_torch.configs import registry, rwkv6_1p6b
from repro_torch.kernels.rwkv import wkv
from repro_torch.models import api, common, ssm
from repro_torch.models.convert import from_reference
from repro_torch.serving.continuous import ContinuousServer
from repro_torch.serving.engine import InferenceEngine

REF_CFG = ARCHS["rwkv6-1.6b"].smoke
CFG = rwkv6_1p6b.SMOKE
TOL = 1e-5   # float32, same algorithm; sums in another order


def _perturbed_tree(cfg, seed=0):
    """The reference's init as numpy, with every layer's ``tmix.wo.w`` and
    ``tmix.decay_w2`` redrawn from N(0, 1/d), so the WKV branch reaches the
    logits."""
    tree = jax.tree_util.tree_map(np.array, ref_api.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    tmix = tree["layers"]["tmix"]
    for leaf, key in ((tmix["wo"], "w"), (tmix, "decay_w2")):
        a = leaf[key]
        leaf[key] = (rng.standard_normal(a.shape) / np.sqrt(cfg.d_model)).astype(a.dtype)
    return tree


@pytest.fixture(scope="module")
def weights():
    """(reference params as JAX arrays, port params): the same numbers."""
    tree = _perturbed_tree(REF_CFG)
    return jax.tree_util.tree_map(jnp.asarray, tree), from_reference(tree, CFG, "cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_state(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["shift_c", "shift_t", "wkv"]
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        _close(got[name], want[name])


def _layer0(params):
    """The first layer's params of a reference tree (stacked) or a port's."""
    if isinstance(params["layers"], list):
        return params["layers"][0]
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"])


# ----------------------------------------------------------------------
# configs, init and the weights bridge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
def test_rwkv_configs_equal_the_reference(which):
    ours = getattr(registry.get("rwkv6-1.6b"), which)
    ref = getattr(ARCHS["rwkv6-1.6b"], which)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.pdt == getattr(torch, str(ref.pdt))


def test_rwkv_spec_equals_the_reference():
    ours, ref = registry.get("rwkv6-1.6b"), ARCHS["rwkv6-1.6b"]
    assert (ours.source, ours.long_strategy, ours.notes) == \
        (ref.source, ref.long_strategy, ref.notes)


def test_seeded_init_has_the_reference_tree():
    """Same leaves, shapes and dtypes as the reference's init (``u`` and
    ``w0`` float32 in a bfloat16 tree), ``wo`` at scale 0, and a seed that
    repeats."""
    cfg = CFG.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_cfg = REF_CFG.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_shapes = jax.eval_shape(lambda: ref_api.init_params(jax.random.PRNGKey(0), ref_cfg))
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_layer = jax.tree_util.tree_map(lambda a: (a.shape[1:], str(a.dtype)),
                                       ref_shapes["layers"])
    got_layer = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                                       params["layers"][0])
    assert got_layer == ref_layer
    assert sorted(params) == sorted(ref_shapes)
    assert common.count_params(params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(ref_shapes))
    tmix = params["layers"][1]["tmix"]
    assert not tmix["wo"]["w"].any() and tmix["decay_w1"].any()
    assert torch.equal(tmix["mix_w2"][0], tmix["mix_w2"][4])
    again = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["layers"][1]["tmix"]["wr"]["w"],
                       again["layers"][1]["tmix"]["wr"]["w"])


def test_converted_ssm_params_keep_every_leaf():
    cfg = CFG.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_cfg = REF_CFG.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_params = ref_api.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = from_reference(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    assert common.count_params(params) == ref_common.count_params(ref_params)
    assert common.param_bytes(params) == ref_common.param_bytes(ref_params)
    assert len(params["layers"]) == cfg.num_layers and "ln_in" in params
    tmix = params["layers"][1]["tmix"]
    assert tmix["u"].dtype == tmix["w0"].dtype == torch.float32
    assert tmix["wk"]["w"].dtype == torch.bfloat16
    want = np.asarray(ref_params["layers"]["tmix"]["wk"]["w"][1])
    np.testing.assert_array_equal(tmix["wk"]["w"].view(torch.int16).numpy(),
                                  want.view(np.int16))


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------

def test_ddlerp_matches(weights):
    ref_params, params = weights
    x, xprev = _rand((2, 7, CFG.d_model), 1), _rand((2, 7, CFG.d_model), 2)
    want = ref_ssm._ddlerp(_layer0(ref_params)["tmix"], jnp.asarray(x), jnp.asarray(xprev),
                           REF_CFG)
    got = ssm._ddlerp(_layer0(params)["tmix"], torch.from_numpy(x), torch.from_numpy(xprev),
                      CFG)
    assert list(got) == list(want) == list(ssm.MIX_KEYS)
    for key in got:
        _close(got[key], want[key])


@pytest.mark.parametrize("t", [1, 9])
def test_time_mix_matches(weights, t):
    """Output, new wkv state and new shift, from a non-zero state."""
    ref_params, params = weights
    d, h = CFG.d_model, CFG.num_heads
    x = _rand((2, t, d), 3)
    state = _rand((2, h, d // h, d // h), 4, 0.3)
    shift = _rand((2, d), 5)
    want = ref_ssm.time_mix(_layer0(ref_params)["tmix"], jnp.asarray(x), jnp.asarray(state),
                            jnp.asarray(shift), REF_CFG)
    s_in = torch.from_numpy(state)
    got = ssm.time_mix(_layer0(params)["tmix"], torch.from_numpy(x), s_in,
                       torch.from_numpy(shift), CFG)
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(s_in, torch.from_numpy(state))   # no out_state: left alone
    got_in = ssm.time_mix(_layer0(params)["tmix"], torch.from_numpy(x), s_in,
                          torch.from_numpy(shift), CFG, out_state=s_in)
    assert got_in[1] is s_in and torch.equal(s_in, got[1])


def test_channel_mix_matches(weights):
    ref_params, params = weights
    x, shift = _rand((3, 6, CFG.d_model), 6), _rand((3, CFG.d_model), 7)
    want = ref_ssm.channel_mix(_layer0(ref_params)["cmix"], jnp.asarray(x),
                               jnp.asarray(shift), REF_CFG)
    got = ssm.channel_mix(_layer0(params)["cmix"], torch.from_numpy(x),
                          torch.from_numpy(shift), CFG)
    for g, w in zip(got, want):
        _close(g, w)


def test_the_wkv_branch_reaches_the_logits(weights):
    """With the redrawn ``wo``, the bonus ``u`` changes the logits: the
    parity tests below do exercise the recurrence."""
    _, params = weights
    toks = torch.from_numpy(_tokens((1, 8), 8))
    base, _ = ssm.forward(params, toks, CFG)
    bumped = {**params, "layers": [{**lp, "tmix": {**lp["tmix"], "u": lp["tmix"]["u"] * 3}}
                                   for lp in params["layers"]]}
    other, _ = ssm.forward(bumped, toks, CFG)
    assert (base - other).abs().max() > 1e-3


# ----------------------------------------------------------------------
# forward, prefill and decode against the reference
# ----------------------------------------------------------------------

def test_forward_logits_and_state_match(weights):
    ref_params, params = weights
    toks = _tokens((2, 11), 9)
    want, ref_state = ref_ssm.forward(ref_params, jnp.asarray(toks), REF_CFG,
                                      return_state=True)
    got, state = ssm.forward(params, torch.from_numpy(toks), CFG, return_state=True)
    _close(got, want)
    _close_state(state, ref_state)


@pytest.mark.parametrize("batch,s", [(1, 5), (3, 12), (2, 33)])
def test_prefill_last_logits_and_state_match(weights, batch, s):
    ref_params, params = weights
    toks = _tokens((batch, s), 10 + s)
    want, ref_state = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, REF_CFG,
                                      cache_len=s + 8)
    got, state = api.prefill(params, {"tokens": torch.from_numpy(toks)}, CFG,
                             cache_len=s + 8)
    _close(got, want)
    _close_state(state, ref_state)


def test_decode_steps_after_prefill_match(weights):
    ref_params, params = weights
    toks = _tokens((2, 7), 11)
    _, ref_state = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, REF_CFG,
                                   cache_len=16)
    _, state = api.prefill(params, {"tokens": torch.from_numpy(toks)}, CFG, cache_len=16)
    nxt = _tokens((2,), 12)
    for pos in range(7, 11):
        want, ref_state = ref_api.decode_step(ref_params, ref_state, jnp.asarray(nxt),
                                              jnp.int32(pos), REF_CFG)
        got, same = api.decode_step(params, state, torch.from_numpy(nxt), pos, CFG)
        assert same is state                        # updated in place
        _close(got, want)
        _close_state(state, ref_state)
        nxt = np.array(jnp.argmax(want, -1))


def test_chunked_prefill_matches_unchunked_and_the_reference(weights):
    """The reference's ``test_ssm_chunked_prefill_matches_unchunked`` with
    chunk=8, and the chunked state against the reference's chunked one."""
    ref_params, params = weights
    toks = _tokens((2, 32), 13)
    l1, s1 = ssm.prefill(params, torch.from_numpy(toks), CFG)
    l2, s2 = ssm.prefill(params, torch.from_numpy(toks), CFG, chunk=8)
    _close(l2, l1)
    _close_state(s2, s1)
    want, ref_state = ref_ssm.prefill(ref_params, jnp.asarray(toks), REF_CFG, chunk=8)
    _close(l2, want)
    _close_state(s2, ref_state)


def test_decode_consistency(weights):
    """prefill(S) + decode(1) == full forward at position S (the reference's
    ``test_decode_consistency`` for rwkv6-1.6b), in the port and against
    the reference's forward."""
    ref_params, params = weights
    s = 12
    toks = _tokens((2, s + 1), 14)
    full, _ = ssm.forward(params, torch.from_numpy(toks), CFG)
    _, state = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])}, CFG,
                           cache_len=s + 8)
    got, _ = api.decode_step(params, state, torch.from_numpy(toks[:, s]), s, CFG)
    _close(got, full[:, -1])
    want, _ = ref_ssm.forward(ref_params, jnp.asarray(toks), REF_CFG)
    _close(got, want[:, -1])


def test_prefill_resets_a_preallocated_state(weights):
    _, params = weights
    toks = torch.from_numpy(_tokens((2, 9), 15))
    want, fresh = api.prefill(params, {"tokens": toks}, CFG)
    cache = api.init_cache(CFG, 2, 64, device="cpu")
    for t in cache.values():
        t.fill_(7.0)       # a stale state must not leak into the prompt
    got, same = api.prefill(params, {"tokens": toks}, CFG, cache=cache)
    assert same is cache
    assert torch.equal(got, want)
    for name in cache:
        assert torch.equal(cache[name], fresh[name])


def test_prefill_refuses_a_last_position(weights):
    _, params = weights
    with pytest.raises(ValueError, match="exact-length"):
        api.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, CFG,
                    last_pos=5)


def test_init_cache_has_the_reference_layout():
    for dtype in (None, torch.bfloat16):
        ref_dtype = None if dtype is None else jnp.bfloat16
        want = ref_ssm.init_cache(REF_CFG, 3, 99, ref_dtype)
        got = api.init_cache(CFG, 3, 99, dtype, device="cpu")
        assert {n: (tuple(t.shape), str(t.dtype).split(".")[-1]) for n, t in got.items()} == \
            {n: (a.shape, str(a.dtype)) for n, a in want.items()}


# ----------------------------------------------------------------------
# the engine against the live reference engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(weights):
    """(reference engine, port engine) on the same perturbed weights; the
    reference's jits take the params as an argument, so assigning them
    swaps its weights."""
    ref_params, params = weights
    ref = ref_engine.InferenceEngine(REF_CFG, seed=0, max_cache=48)
    ref.params = ref_params
    return ref, InferenceEngine(CFG, max_cache=48, params=params, device="cpu")


@pytest.mark.parametrize("prompt,n_new", [
    ([[3, 1, 4, 1, 5, 9, 2, 6]], 6),
    ([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]], 9),
    ([[11, 2, 40, 9, 3, 3, 1, 8, 30, 2, 5, 6, 7]], 12),
    ([[300, 2, 41], [9, 500, 18]], 5),
])
def test_engine_greedy_tokens_equal_reference(engines, prompt, n_new):
    ref, eng = engines
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), n_new).tokens)
    got = eng.generate(np.asarray(prompt), n_new).tokens
    assert got.shape == (len(prompt), n_new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_stream_equals_generate(engines):
    _, eng = engines
    prompt = np.asarray([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]])
    for temp, seed in ((0.0, 0), (0.9, 11)):
        fused = eng.generate(prompt, 9, temperature=temp, seed=seed)
        stream = eng.generate_stream(prompt, 9, temperature=temp, seed=seed)
        assert torch.equal(fused.tokens, stream.tokens)
    assert len(stream.token_walls) == 8


def test_engine_keeps_exact_prompt_lengths(weights):
    """No bucketing for a recurrent state: lengths 5, 6 and 7 are three
    prefill shapes, as in the reference's jit cache."""
    ref_params, params = weights
    ref = ref_engine.InferenceEngine(REF_CFG, seed=0, max_cache=32)
    ref.params = ref_params
    eng = InferenceEngine(CFG, max_cache=32, params=params, device="cpu")
    for s in (5, 6, 7):
        ref.generate(jnp.ones((1, s), jnp.int32), 4)
        eng.generate([[1] * s], 4)
    assert eng.compile_stats()["prefill"] == 3 == ref.compile_stats()["prefill"]
    assert eng._prefill_shapes(12, 4) == (12, 16) == ref._prefill_shapes(12, 4)
    assert eng._prefill_shapes(40, 9) == (40, 32)


def test_engine_reuses_and_resets_its_state(engines):
    """Two prompts in a row on one engine give a fresh engine's tokens for
    each: the reused state is reset before every prompt."""
    _, eng = engines
    first, second = [[5, 9, 1, 33, 2, 8]], [[40, 4, 4, 2, 7, 1]]
    eng.generate(first, 6)
    state = eng._cache
    got = eng.generate(second, 6).tokens
    assert eng._cache is state and state["wkv"].shape[:2] == (CFG.num_layers, 1)
    fresh = InferenceEngine(CFG, max_cache=48, params=eng.params, device="cpu")
    assert torch.equal(got, fresh.generate(second, 6).tokens)
    assert torch.equal(eng.generate(first, 6).tokens, fresh.generate(first, 6).tokens)


def test_engine_warmup_and_stats(weights):
    ref_params, params = weights
    eng = InferenceEngine(CFG, max_cache=32, params=params, device="cpu")
    assert eng.warmup(2, 8) >= 0 and eng.compiled
    assert eng.compile_stats()["prefill"] == 1
    assert eng.stats()["arch"] == CFG.name
    assert eng.stats()["params"] == ref_common.count_params(ref_params)


def test_continuous_server_refuses_the_recurrent_family():
    """The reference's ``test_rejects_non_transformer_family``."""
    with pytest.raises(ValueError, match="KV-cache layout"):
        ContinuousServer(CFG, slots=2, max_seq=16, device="cpu")


def test_serve_cli_serves_every_rwkv_request_on_the_cpu(capsys):
    from repro_torch.launch import serve
    before = wkv.launches
    outs = serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--requests", "5",
                       "--n-new", "3", "--device", "cpu"])
    assert sorted(outs) == list(range(5))
    assert all(len(t) == 3 for t in outs.values())
    assert "rwkv6-smoke on cpu" in capsys.readouterr().out
    assert wkv.launches == before      # the CPU takes the plain version
