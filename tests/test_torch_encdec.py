"""The port's audio family (the Whisper encoder-decoder, ``models/encdec.py``)
against the reference package on the same weights, frames and tokens, on
the CPU: the smoke config, float32.

The reference's init sets the attention and MLP biases to zero and the
LayerNorms' scale and bias to 1 and 0, which would hide a bias or a norm
applied on the wrong axis, so every parity test draws them anew and hands
the same arrays to both sides.  Logits and caches are held within 1e-5,
token streams exactly."""
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
from repro.models import encdec as ref_encdec
from repro.serving import engine as ref_engine
from repro_torch.configs import whisper_tiny
from repro_torch.core import calibration
from repro_torch.models import api, common, encdec, layers
from repro_torch.models.convert import from_reference
from repro_torch.serving.continuous import ContinuousServer
from repro_torch.serving.engine import InferenceEngine

REF_CFG = ARCHS["whisper-tiny"].smoke
CFG = whisper_tiny.SMOKE
TOL = 1e-5   # float32, same algorithm; sums in another order
SE = CFG.encoder_seq


def _redrawn_tree(seed=0):
    """The reference's init as numpy, with every bias (``b``, ``bias``) from
    N(0, 0.1) and every LayerNorm ``scale`` from N(1, 0.2)."""
    tree = jax.tree_util.tree_map(np.array, ref_api.init_params(jax.random.PRNGKey(seed),
                                                                REF_CFG))
    rng = np.random.default_rng(seed + 100)
    draw = {"b": (0.0, 0.1), "bias": (0.0, 0.1), "scale": (1.0, 0.2)}

    def walk(t):
        if not isinstance(t, dict):
            return t
        return {k: (rng.normal(*draw[k], v.shape).astype(v.dtype) if k in draw else walk(v))
                for k, v in t.items()}
    return walk(tree)


@pytest.fixture(scope="module")
def weights():
    """(reference params as JAX arrays, port params): the same numbers."""
    tree = _redrawn_tree()
    return jax.tree_util.tree_map(jnp.asarray, tree), from_reference(tree, CFG, "cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape)


def _frames(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, SE, CFG.d_model)).astype(np.float32)


def _inputs(toks, frames):
    return ({"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks), "frame_embeds": torch.from_numpy(frames)})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_cache(got, want):
    assert sorted(got) == sorted(want) == ["k", "v", "xk", "xv"]
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        _close(got[name], want[name])


# ----------------------------------------------------------------------
# init, the cache layout and the weights bridge
# ----------------------------------------------------------------------

def test_convert_keeps_every_leaf(weights):
    ref_params, params = weights
    assert len(params["enc_layers"]) == CFG.encoder_layers
    assert len(params["dec_layers"]) == CFG.num_layers
    assert common.count_params(params) == ref_common.count_params(ref_params)
    np.testing.assert_array_equal(params["dec_pos"].numpy(), np.asarray(ref_params["dec_pos"]))
    np.testing.assert_array_equal(params["dec_layers"][1]["xattn"]["wk"]["b"].numpy(),
                                  np.asarray(ref_params["dec_layers"]["xattn"]["wk"]["b"][1]))
    assert "unembed" not in params["embed"]                  # tied embeddings


def test_seeded_init_has_the_reference_tree():
    want = jax.eval_shape(lambda: ref_api.init_params(jax.random.PRNGKey(0), REF_CFG))
    params = api.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert tuple(params["dec_pos"].shape) == want["dec_pos"].shape == (encdec.MAX_DEC_POS,
                                                                       CFG.d_model)
    layer = jax.tree_util.tree_map(lambda x: x.shape[1:], want["dec_layers"])
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params["dec_layers"][0]) == layer
    assert common.count_params(params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


def test_init_cache_has_the_reference_layout():
    want = ref_encdec.init_cache(REF_CFG, 3, 20)
    got = api.init_cache(CFG, 3, 20, device="cpu")
    assert {n: tuple(t.shape) for n, t in got.items()} == {n: a.shape for n, a in want.items()}
    assert got["xk"].shape[2] == SE


@pytest.mark.parametrize("seq,d", [(SE, CFG.d_model), (1500, 384), (7, 10)])
def test_sinusoid_matches(seq, d):
    """Within 1e-6 at the smoke config's 16 frames.  The angle is the
    position times a rate from ``exp``, whose last bit XLA and torch may
    round apart: at position p that is up to p ulps of the rate in the
    angle, so over whisper-tiny's 1500 frames the bar is 1500 * 2^-23."""
    tol = 1e-6 if seq <= SE else seq * 2.0 ** -23
    _close(encdec._sinusoid(seq, d, "cpu"), ref_encdec._sinusoid(seq, d), tol=tol)


# ----------------------------------------------------------------------
# the model: encoder, forward, prefill and decode
# ----------------------------------------------------------------------

def test_encode_matches(weights):
    ref_params, params = weights
    frames = _frames(2, 1)
    _close(encdec.encode(params, torch.from_numpy(frames), CFG),
           ref_encdec.encode(ref_params, jnp.asarray(frames), REF_CFG))


@pytest.mark.parametrize("s", [1, 9])
def test_forward_logits_match(weights, s):
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((2, s), s), _frames(2, s))
    want, _ = ref_encdec.forward(ref_params, ref_in, REF_CFG)
    got, _ = encdec.forward(params, t_in, CFG)
    _close(got, want)


@pytest.mark.parametrize("s,cache_len", [(6, 6), (9, 20)])
def test_prefill_logits_and_cache_match(weights, s, cache_len):
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((3, s), 10 + s), _frames(3, s))
    want, ref_cache = ref_api.prefill(ref_params, ref_in, REF_CFG, cache_len)
    got, cache = api.prefill(params, t_in, CFG, cache_len)
    _close(got, want)
    _close_cache(cache, ref_cache)


def test_long_decoder_prompt_takes_the_chunked_attention_and_matches(weights):
    """S = 3072 > 2048 and a multiple of 1024: the reference's chunked
    causal branch (window 0), on both sides."""
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((1, 3072), 3), _frames(1, 3))
    want, ref_cache = ref_api.prefill(ref_params, ref_in, REF_CFG)
    with mock.patch.object(encdec, "attention_chunked",
                           wraps=layers.attention_chunked) as chunked:
        got, cache = api.prefill(params, t_in, CFG)
    assert chunked.call_count == CFG.num_layers
    _close(got, want)
    _close_cache(cache, ref_cache)


@pytest.mark.parametrize("form", ["int", "rows"])
def test_decode_steps_match(weights, form):
    """Steps after a prefill: the self-attention cache grows, the
    cross-attention cache is carried unchanged; a host int or a (B,) device
    tensor of equal positions against the reference's scalar."""
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((2, 7), 20), _frames(2, 20))
    _, ref_cache = ref_api.prefill(ref_params, ref_in, REF_CFG, 16)
    _, cache = api.prefill(params, t_in, CFG, 16)
    xk = cache["xk"].clone()
    nxt = _tokens((2,), 21)
    for pos in range(7, 12):
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                              jnp.int32(pos), REF_CFG)
        tp = pos if form == "int" else torch.tensor([pos, pos])
        got, cache = api.decode_step(params, cache, torch.from_numpy(nxt), tp, CFG)
        _close(got, want)
        _close_cache(cache, ref_cache)
        nxt = np.array(jnp.argmax(want, -1))
    assert torch.equal(cache["xk"], xk)


def test_decode_per_row_positions_match_each_row_alone(weights):
    """Rows at different positions in one step (each row's own decoder
    position gathered, its own write and mask): each equals the reference
    decoding it alone."""
    ref_params, params = weights
    lens, frames = (4, 9), _frames(2, 30)
    ref_caches, caches = [], []
    for r, s in enumerate(lens):
        ref_in, t_in = _inputs(_tokens((1, s), 31 + r), frames[r:r + 1])
        ref_caches.append(ref_api.prefill(ref_params, ref_in, REF_CFG, 16)[1])
        caches.append(api.prefill(params, t_in, CFG, 16)[1])
    cache = {n: torch.cat([c[n] for c in caches], dim=1) for n in caches[0]}
    pos, nxt = np.array(lens), _tokens((2,), 33)
    for _ in range(3):
        got, cache = api.decode_step(params, cache, torch.from_numpy(nxt),
                                     torch.from_numpy(pos), CFG)
        for r in range(2):
            want, ref_caches[r] = ref_api.decode_step(ref_params, ref_caches[r],
                                                      jnp.asarray(nxt[r:r + 1]),
                                                      jnp.int32(pos[r]), REF_CFG)
            _close(got[r:r + 1], want)
        nxt, pos = got.argmax(-1).numpy(), pos + 1


def test_prefill_writes_a_preallocated_cache_in_place(weights):
    _, params = weights
    _, t_in = _inputs(_tokens((2, 8), 40), _frames(2, 40))
    want, fresh = api.prefill(params, t_in, CFG, 16)
    cache = api.init_cache(CFG, 2, 16, device="cpu")
    for t in cache.values():
        t.fill_(7.0)     # stale contents past the prompt must be zeroed
    got, same = api.prefill(params, t_in, CFG, 16, cache=cache)
    assert same is cache and torch.equal(got, want)
    for n in cache:
        assert torch.equal(cache[n], fresh[n])


def test_prefill_needs_frames_and_exact_prompts(weights):
    _, params = weights
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(KeyError, match="frame_embeds"):
        api.prefill(params, {"tokens": toks}, CFG)
    with pytest.raises(ValueError, match="exact-length"):
        api.prefill(params, {"tokens": toks, "frame_embeds": torch.zeros((1, SE, CFG.d_model))},
                    CFG, last_pos=2)


# ----------------------------------------------------------------------
# the engine against the live reference engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(weights):
    """(reference engine, port engine) on the same redrawn weights; both
    feed the reference's zero frame embeddings."""
    ref_params, params = weights
    ref = ref_engine.InferenceEngine(REF_CFG, seed=0, max_cache=48)
    ref.params = ref_params
    return ref, InferenceEngine(CFG, max_cache=48, params=params, device="cpu")


@pytest.mark.parametrize("prompt,n_new", [
    ([[3, 1, 4, 1, 5, 9, 2, 6]], 6),
    ([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]], 20),
    ([[11, 2, 40]], 40),
])
def test_engine_greedy_tokens_and_shapes_equal_reference(engines, prompt, n_new):
    ref, eng = engines
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), n_new).tokens)
    got = eng.generate(np.asarray(prompt), n_new).tokens
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(eng.generate_stream(np.asarray(prompt), n_new).tokens.numpy(),
                                  want)
    assert eng.compile_stats()["prefill"] == ref.compile_stats()["prefill"]
    assert eng._prefill_shapes(5, 20) == ref._prefill_shapes(5, 20)


def test_engine_feeds_static_zero_frames(engines):
    """The zero frame embeddings live beside the cache, one buffer a batch,
    which the prefill reads (a captured prefill reads it by address)."""
    _, eng = engines
    eng.generate([[1, 2, 3], [4, 5, 6]], 3)
    frames = eng._modal["frame_embeds"]
    assert tuple(frames.shape) == (2, SE, CFG.d_model) and not frames.any()
    eng.generate([[7, 8, 9, 1], [2, 3, 4, 5]], 3)
    assert eng._modal["frame_embeds"] is frames


def test_sampled_engine_is_seeded(engines):
    _, eng = engines
    prompt = np.asarray([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]])
    a = eng.generate(prompt, 12, temperature=0.9, seed=5).tokens
    assert torch.equal(a, eng.generate_stream(prompt, 12, temperature=0.9, seed=5).tokens)
    assert not torch.equal(a, eng.generate(prompt, 12, temperature=0.9, seed=6).tokens)


def test_continuous_server_refuses_the_audio_family():
    with pytest.raises(ValueError, match="KV-cache layout"):
        ContinuousServer(CFG, slots=2, max_seq=16, device="cpu")


def test_calibration_takes_no_batch_curve_as_the_reference():
    from repro.core import calibration as ref_calibration
    want = ref_calibration.measure_model("whisper-tiny", repeats=1)
    got = calibration.measure_model("whisper-tiny", smoke=True, device="cpu", repeats=1)
    assert got["batch_curve"] == want["batch_curve"] == []
    assert set(got) == set(want) and got["warm_exec_s"] > 0


def test_serve_cli_serves_every_request_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "whisper-tiny", "--smoke", "--requests", "5",
                       "--n-new", "3", "--device", "cpu"])
    assert sorted(outs) == list(range(5)) and all(len(t) == 3 for t in outs.values())
    assert "whisper-smoke on cpu" in capsys.readouterr().out


def test_config_spec_equals_the_reference():
    spec, ref_spec = whisper_tiny.SPEC, ARCHS["whisper-tiny"]
    assert dataclasses.asdict(spec.config) == dataclasses.asdict(ref_spec.config)
    assert encdec.MAX_DEC_POS == ref_encdec.MAX_DEC_POS
