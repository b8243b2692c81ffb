"""The port's vlm family (LLaVA-NeXT, ``models/vlm.py``) against the
reference package on the same weights, patch embeddings and tokens, on the
CPU: the smoke config, float32.  Its prefill runs K1's plain version and its
decode K2's, as the reference's own tests run them on the CPU.

The patch embeddings are random, N(0, 0.02) as a projector's output: with
zeros a merge that drops them would pass.  Logits and caches are held within
1e-5, token streams exactly.  The reference's continuous server accepts a
vlm config and then fails to admit its requests (its admission hands the vlm
prefill no patch embeddings); the port follows it, and a test shows both
failing at the same call."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import api as ref_api
from repro.models import transformer as ref_transformer
from repro.models import vlm as ref_vlm
from repro.serving import continuous as ref_continuous
from repro.serving import engine as ref_engine
from repro_torch.configs import llava_next_mistral_7b
from repro_torch.core import calibration
from repro_torch.models import api, transformer, vlm
from repro_torch.models.convert import from_reference
from repro_torch.serving.continuous import ContinuousServer, Request
from repro_torch.serving.engine import InferenceEngine

REF_CFG = ARCHS["llava-next-mistral-7b"].smoke
CFG = llava_next_mistral_7b.SMOKE
TOL = 1e-5   # float32, same algorithm; sums in another order
P = CFG.num_image_tokens


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params): one draw, converted."""
    ref_params = ref_api.init_params(jax.random.PRNGKey(0), REF_CFG)
    return ref_params, from_reference(jax.tree_util.tree_map(np.asarray, ref_params), CFG, "cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape)


def _patches(b, seed=0, n=P):
    return (np.random.default_rng(seed).standard_normal((b, n, CFG.d_model))
            * 0.02).astype(np.float32)


def _inputs(toks, patches):
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(patches)})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
# the merge and the transformer's input_embeds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s,n", [(12, P), (5, P), (12, 3)])   # S > P, S < P, a short P
def test_merge_embeddings_matches(weights, s, n):
    ref_params, params = weights
    toks, patches = _tokens((2, s), s), _patches(2, s, n)
    want = ref_vlm.merge_embeddings(ref_params, jnp.asarray(toks), jnp.asarray(patches), REF_CFG)
    got = vlm.merge_embeddings(params, torch.from_numpy(toks), torch.from_numpy(patches), CFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :min(s, n)].numpy(), patches[:, :min(s, n)])


def test_transformer_takes_input_embeds(weights):
    """``forward`` and ``prefill`` over given embeddings equal the
    reference's, and differ from the tokens' own embeddings."""
    ref_params, params = weights
    toks = _tokens((2, 9), 1)
    x = np.random.default_rng(2).standard_normal((2, 9, CFG.d_model)).astype(np.float32) * 0.1
    want, _ = ref_transformer.forward(ref_params, jnp.asarray(toks), REF_CFG,
                                      input_embeds=jnp.asarray(x))
    got, _ = transformer.forward(params, torch.from_numpy(toks), CFG,
                                 input_embeds=torch.from_numpy(x))
    _close(got, want)
    want, ref_cache = ref_transformer.prefill(ref_params, jnp.asarray(toks), REF_CFG, 16,
                                              input_embeds=jnp.asarray(x))
    got, cache = transformer.prefill(params, torch.from_numpy(toks), CFG, 16,
                                     input_embeds=torch.from_numpy(x))
    _close(got, want)
    _close(cache["k"], ref_cache["k"])
    plain, _ = transformer.prefill(params, torch.from_numpy(toks), CFG, 16)
    assert not torch.allclose(plain, got)


# ----------------------------------------------------------------------
# the model: forward, prefill and decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s", [6, 12])
def test_forward_logits_match_and_see_the_patches(weights, s):
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((2, s), s), _patches(2, 10 + s))
    want, _ = ref_vlm.forward(ref_params, ref_in, REF_CFG)
    got, _ = vlm.forward(params, t_in, CFG)
    _close(got, want)
    zeros, _ = vlm.forward(params, {**t_in, "patch_embeds": torch.zeros_like(t_in["patch_embeds"])},
                           CFG)
    assert (got - zeros).abs().max() > 1e-3          # the patches reach the logits


@pytest.mark.parametrize("s,cache_len", [(12, 12), (10, 24)])
def test_prefill_logits_and_cache_match(weights, s, cache_len):
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((3, s), 20 + s), _patches(3, 20 + s))
    want, ref_cache = ref_api.prefill(ref_params, ref_in, REF_CFG, cache_len)
    got, cache = api.prefill(params, t_in, CFG, cache_len)
    _close(got, want)
    for n in ("k", "v"):
        assert cache[n].shape == ref_cache[n].shape
        _close(cache[n], ref_cache[n])


@pytest.mark.parametrize("form", ["int", "rows"])
def test_decode_steps_match(weights, form):
    ref_params, params = weights
    ref_in, t_in = _inputs(_tokens((2, 11), 30), _patches(2, 30))
    _, ref_cache = ref_api.prefill(ref_params, ref_in, REF_CFG, 20)
    _, cache = api.prefill(params, t_in, CFG, 20)
    nxt = _tokens((2,), 31)
    for pos in range(11, 15):
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                              jnp.int32(pos), REF_CFG)
        tp = pos if form == "int" else torch.tensor([pos, pos])
        got, cache = api.decode_step(params, cache, torch.from_numpy(nxt), tp, CFG)
        _close(got, want)
        _close(cache["v"], ref_cache["v"])
        nxt = np.array(jnp.argmax(want, -1))


def test_prefill_writes_a_preallocated_cache_in_place(weights):
    _, params = weights
    _, t_in = _inputs(_tokens((2, 10), 40), _patches(2, 40))
    want, fresh = api.prefill(params, t_in, CFG, 16)
    cache = api.init_cache(CFG, 2, 16, device="cpu")
    for t in cache.values():
        t.fill_(7.0)
    got, same = api.prefill(params, t_in, CFG, 16, cache=cache)
    assert same is cache and torch.equal(got, want)
    assert torch.equal(cache["k"], fresh["k"]) and torch.equal(cache["v"], fresh["v"])


def test_prefill_needs_patches_and_exact_prompts(weights):
    _, params = weights
    toks = torch.zeros((1, 10), dtype=torch.long)
    with pytest.raises(KeyError, match="patch_embeds"):
        api.prefill(params, {"tokens": toks}, CFG)
    with pytest.raises(ValueError, match="exact-length"):
        api.prefill(params, {"tokens": toks, "patch_embeds": torch.zeros((1, P, CFG.d_model))},
                    CFG, last_pos=3)


# ----------------------------------------------------------------------
# the engine against the live reference engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(weights):
    """(reference engine, port engine) on the same weights; both feed the
    reference's zero patch embeddings."""
    ref_params, params = weights
    ref = ref_engine.InferenceEngine(REF_CFG, seed=0, max_cache=96)
    ref.params = ref_params
    return ref, InferenceEngine(CFG, max_cache=96, params=params, device="cpu")


@pytest.mark.parametrize("prompt,n_new", [
    ([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]], 6),        # the 8 image positions and 3 text
    ([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]], 20),        # all image positions
    ([[11, 2, 40, 9, 3, 3, 1, 8, 30, 2]], 70),       # past one token block
])
def test_engine_greedy_tokens_and_shapes_equal_reference(engines, prompt, n_new):
    ref, eng = engines
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), n_new).tokens)
    got = eng.generate(np.asarray(prompt), n_new).tokens
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(eng.generate_stream(np.asarray(prompt), n_new).tokens.numpy(),
                                  want)
    assert eng.compile_stats()["prefill"] == ref.compile_stats()["prefill"]
    assert eng._prefill_shapes(10, 20) == ref._prefill_shapes(10, 20)


def test_engine_feeds_static_zero_patches(engines):
    _, eng = engines
    eng.generate([[1, 2, 3]], 3)
    patches = eng._modal["patch_embeds"]
    assert tuple(patches.shape) == (1, P, CFG.d_model) and not patches.any()
    eng.generate([[7, 8, 9, 1]], 3)
    assert eng._modal["patch_embeds"] is patches


def test_sampled_engine_is_seeded(engines):
    _, eng = engines
    prompt = np.asarray([[7, 7, 2, 9, 1, 4, 4, 3, 9, 2], [5, 0, 3, 3, 8, 1, 2, 3, 4, 5]])
    a = eng.generate(prompt, 12, temperature=0.9, seed=5).tokens
    assert torch.equal(a, eng.generate_stream(prompt, 12, temperature=0.9, seed=5).tokens)
    assert not torch.equal(a, eng.generate(prompt, 12, temperature=0.9, seed=6).tokens)


# ----------------------------------------------------------------------
# the reference's admission fault, which the port follows
# ----------------------------------------------------------------------

def test_continuous_server_fails_to_admit_a_vlm_request_as_the_reference(weights):
    """Both servers accept the vlm config; both raise ``KeyError`` for the
    missing patch embeddings at the first admission."""
    ref_params, params = weights
    ref = ref_continuous.ContinuousServer(REF_CFG, slots=2, max_seq=32, seed=0)
    srv = ContinuousServer(CFG, slots=2, max_seq=32, params=params, device="cpu")
    prompt = _tokens((10,), 50).tolist()
    ref.submit(ref_continuous.Request(rid=0, prompt=prompt, n_new=4))
    srv.submit(Request(rid=0, prompt=prompt, n_new=4))
    with pytest.raises(KeyError, match="patch_embeds"):
        ref.prefill_pending()
    with pytest.raises(KeyError, match="patch_embeds"):
        srv.prefill_pending()


def test_calibration_fails_at_the_batch_curve_as_the_reference():
    from repro.core import calibration as ref_calibration
    with pytest.raises(KeyError, match="patch_embeds"):
        ref_calibration.measure_model("llava-next-mistral-7b", repeats=1)
    with mock.patch.object(calibration, "_measure_batch_curve",
                           wraps=calibration._measure_batch_curve) as batch_curve, \
            pytest.raises(KeyError, match="patch_embeds"):
        calibration.measure_model("llava-next-mistral-7b", smoke=True, device="cpu", repeats=1)
    assert batch_curve.call_count == 1         # the engine's part ran; the curve failed


def test_serve_cli_serves_every_request_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "llava-next-mistral-7b", "--smoke", "--requests", "5",
                       "--n-new", "3", "--device", "cpu"])
    assert sorted(outs) == list(range(5)) and all(len(t) == 3 for t in outs.values())
    assert "llava-smoke on cpu" in capsys.readouterr().out


def test_config_spec_equals_the_reference():
    spec, ref_spec = llava_next_mistral_7b.SPEC, ARCHS["llava-next-mistral-7b"]
    assert dataclasses.asdict(spec.config) == dataclasses.asdict(ref_spec.config)
    assert spec.config.num_image_tokens == 2880
