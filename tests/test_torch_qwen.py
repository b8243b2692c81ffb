"""qwen2.5-32b on the port: its QKV-bias branch against the live reference, and
its deployment on the port's serverless platform from a measured entry.

The reference's init sets every bias to zero, which would hide a bias
dropped, added to the wrong projection or broadcast over the wrong axis; so
the parity tests redraw each layer's q, k and v biases from a numpy seed and
hand the same arrays to both sides (``from_reference``).  The smoke config
is float32: logits within 1e-5, token streams and completion order exactly.

The platform tests hand one v2 calibration dict holding a qwen2.5-32b entry
of its full-width size to both packages: the port's platform deploys it on
``modal_gpu`` (no package limit there) and its reports equal the
reference's, tolerance 0.  The reference is imported at the top: every test
here runs on the CPU."""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.core import calibration as r_cal
from repro.core import container as r_container
from repro.core import platform as r_platform
from repro.core import simulator as r_simulator
from repro.core import workload as r_workload
from repro.core.cluster import policies as r_policies
from repro.models import api as ref_api
from repro.serving import continuous as ref_continuous
from repro.serving import engine as ref_engine
from repro_torch.configs import qwen2p5_32b
from repro_torch.core import calibration as p_cal
from repro_torch.core import container as p_container
from repro_torch.core import platform as p_platform
from repro_torch.core import simulator as p_simulator
from repro_torch.core import workload as p_workload
from repro_torch.core.cluster import policies as p_policies
from repro_torch.models import api, common
from repro_torch.models.convert import from_reference
from repro_torch.serving.continuous import ContinuousServer, Request
from repro_torch.serving.engine import InferenceEngine

ARCH = "qwen2.5-32b"
REF_CFG = ARCHS[ARCH].smoke
CFG = qwen2p5_32b.SMOKE
TOL = 1e-5          # float32, the same algorithm; sums in another order
BIAS_STD = 0.5      # as large as a q or k entry's spread: the branch moves every logit
MAX_CACHE = 64


def _tree(seed=0):
    """The reference's init as numpy, each layer's q, k and v bias drawn
    from N(0, ``BIAS_STD``)."""
    tree = jax.tree_util.tree_map(np.array, ref_api.init_params(jax.random.PRNGKey(seed),
                                                                REF_CFG))
    rng = np.random.default_rng(seed + 100)
    attn = tree["layers"]["attn"]
    for key in ("wq", "wk", "wv"):
        b = attn[key]["b"]
        assert not b.any()
        attn[key]["b"] = (rng.standard_normal(b.shape) * BIAS_STD).astype(b.dtype)
    return tree


@pytest.fixture(scope="module")
def weights():
    """(reference params as JAX arrays, port params): the same numbers."""
    tree = _tree()
    return jax.tree_util.tree_map(jnp.asarray, tree), from_reference(tree, CFG, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape)


def test_the_configs_are_the_references_with_the_bias_and_a_group_of_five():
    full, ref_full = qwen2p5_32b.CONFIG, ARCHS[ARCH].config
    for key in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                "head_dim", "qkv_bias", "rope_theta"):
        assert getattr(full, key) == getattr(ref_full, key), key
        assert getattr(CFG, key) == getattr(REF_CFG, key), key
    assert CFG.qkv_bias and full.num_heads // full.num_kv_heads == 5


def test_the_port_takes_every_redrawn_bias(weights):
    ref_params, params = weights
    for i, layer in enumerate(params["layers"]):
        for key in ("wq", "wk", "wv"):
            b = layer["attn"][key]["b"]
            assert b.abs().max().item() > 0.1
            np.testing.assert_array_equal(b.numpy(),
                                          np.asarray(ref_params["layers"]["attn"][key]["b"][i]))


@pytest.mark.parametrize("last_pos", [None, 6])
def test_prefill_and_decode_with_the_bias_match_the_reference(weights, last_pos):
    """The prefill's last logits (at the last position, and at a padded
    prompt's last real one) and cache, then three decode steps at a host
    and at per-row device positions, within 1e-5; the same run without
    the biases moves the logits far past that."""
    ref_params, params = weights
    tokens = _tokens((3, 9), 5)
    want, ref_cache = ref_api.prefill(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                      REF_CFG, 24, last_pos=last_pos)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, CFG, 24,
                             last_pos=last_pos)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    step = _tokens((3, 3), 6)
    for i in range(3):
        pos = 9 + i
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache,
                                              jnp.asarray(step[i], jnp.int32),
                                              jnp.int32(pos), REF_CFG)
        got, cache = api.decode_step(params, cache, torch.from_numpy(step[i]),
                                     pos if i == 0 else torch.full((3,), pos), CFG)
        _close(got, want)
    plain, _ = api.prefill(_without_bias(params), {"tokens": torch.from_numpy(tokens)}, CFG,
                           24, last_pos=last_pos)
    first, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, CFG, 24,
                           last_pos=last_pos)
    assert (plain - first).abs().max().item() > 100 * TOL


def _without_bias(params):
    out = dict(params, layers=[])
    for layer in params["layers"]:
        attn = {k: ({"w": v["w"]} if k in ("wq", "wk", "wv") else v)
                for k, v in layer["attn"].items()}
        out["layers"].append(dict(layer, attn=attn))
    return out


def test_engine_greedy_tokens_with_the_bias_equal_the_reference(weights):
    ref_params, params = weights
    ref_eng = ref_engine.InferenceEngine(REF_CFG, seed=0, max_cache=MAX_CACHE)
    ref_eng.params = ref_params
    eng = InferenceEngine(CFG, max_cache=MAX_CACHE, params=params, device="cpu")
    for b, s, n_new in ((1, 5, 6), (2, 7, 9), (4, 13, 5), (2, 8, 12)):
        prompt = _tokens((b, s), 100 * b + s)
        want = np.asarray(ref_eng.generate(jnp.asarray(prompt, jnp.int32), n_new).tokens)
        np.testing.assert_array_equal(eng.generate(prompt, n_new).tokens.numpy(), want)


@pytest.mark.parametrize("n_req,slots,max_seq,seed", [(7, 3, 48, 0), (9, 4, 64, 1)])
def test_continuous_server_with_the_bias_equals_the_reference(weights, n_req, slots,
                                                              max_seq, seed):
    """Completions (tokens and steps in flight), their order, and the
    server's steps equal the live reference's."""
    ref_params, params = weights
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, CFG.vocab_size, size=int(rng.integers(2, 20))).tolist(),
             int(rng.integers(2, 12))) for i in range(n_req)]
    r = ref_continuous.ContinuousServer(REF_CFG, slots=slots, max_seq=max_seq, seed=0)
    r.params = ref_params
    srv = ContinuousServer(CFG, slots=slots, max_seq=max_seq, params=params, device="cpu")
    done = []
    for server, cls in ((r, ref_continuous.Request), (srv, Request)):
        for rid, prompt, n in reqs:
            server.submit(cls(rid=rid, prompt=list(prompt), n_new=n))
        done.append([(c.rid, c.tokens, c.steps_in_flight) for c in server.run()])
    assert done[1] == done[0]
    assert srv.steps == r.steps


# ----------------------------------------------------------------------
# the deploy path: a full-width entry on the port's platform
# ----------------------------------------------------------------------

@functools.cache
def _package_mb() -> float:
    """qwen2.5-32b's bf16 weights at full width, in MB: its package."""
    return common.param_bytes(api.abstract_params(qwen2p5_32b.CONFIG)) / 1e6


def _cache() -> dict:
    """A v2 cache with one qwen2.5-32b entry of full-width size; the times
    are of the order an H100 gives."""
    return {"schema_version": 2, "host": {"backend": "cuda", "configs": "full"}, "models": {
        ARCH: {"kind": "llm", "warm_exec_s": 0.4127, "init_s": 6.21, "compile_s": 3.87,
               "package_mb": _package_mb(), "tokens_per_s": 41.5,
               "batch_curve": [[1, 1.0], [2, 0.51], [4, 0.26]]}}}


@pytest.fixture
def isolated(monkeypatch):
    monkeypatch.setattr(r_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(p_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(r_container, "_ids", itertools.count())
    monkeypatch.setattr(p_container, "_ids", itertools.count())


def test_the_package_is_the_full_width_models():
    assert 65_000 < _package_mb() < 66_000    # 32.8 B params in bf16


def test_a_full_width_entry_deploys_on_modal_gpu_as_in_the_reference(isolated):
    """The port's platform, built on the cache, deploys qwen2.5-32b on
    ``modal_gpu`` at 16384 MB and refuses it on ``lambda``, as the
    reference's; its handler and spec equal the reference's, and its cold,
    warm and scalability reports equal the reference platform's on that
    handler."""
    cache = _cache()
    plat = p_platform.ServerlessPlatform(seed=0, calibrated=cache)
    ref = r_platform.ServerlessPlatform(seed=0, use_fallback_calibration=True)
    ref_h = r_cal.modern_handler(ARCH, calibrated=cache)
    assert dataclasses.asdict(p_cal.modern_handler(ARCH, calibrated=cache)) == \
        dataclasses.asdict(ref_h)
    for plat_, deploy in ((plat, lambda mb: plat.deploy_model(ARCH, mb)),
                          (ref, lambda mb: ref.deploy(ref_h, mb))):
        with pytest.raises(ValueError, match="512"):
            deploy(1536)
    spec = plat.deploy_model(ARCH, 16384, provider="modal_gpu")
    ref_spec = ref.deploy(ref_h, 16384, provider="modal_gpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    for experiment in ("run_cold_experiment", "run_warm_experiment",
                       "run_scalability_experiment"):
        got, want = getattr(plat, experiment)(spec), getattr(ref, experiment)(ref_spec)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), experiment
    cold = plat.run_cold_experiment(spec)
    assert cold.cold_starts == 5
    assert cold.cold.mean_response_s > _package_mb() / 1000.0     # the 1000 MB/s load


@pytest.mark.parametrize("jitter", [0.0, 0.03])
def test_cold_and_warm_records_equal_the_reference_simulator(isolated, jitter):
    """The port's ``Simulator`` on the deployed spec against the reference's
    ``Simulator`` on the equal handler: a cold probe, and a burst primed
    well past the cold start, record for record; at jitter 0 the first
    cold is its breakdown plus a warm response."""
    cache = _cache()
    spec = p_platform.ServerlessPlatform(seed=0, calibrated=cache).deploy_model(
        ARCH, 16384, provider="modal_gpu")
    ref_spec = r_platform.ServerlessPlatform(seed=0, use_fallback_calibration=True).deploy(
        r_cal.modern_handler(ARCH, calibrated=cache), 16384, provider="modal_gpu")
    lead = 120.0
    for make, ref_make in ((lambda w: w.cold_probe(), lambda w: w.cold_probe()),
                           (lambda w: [w.Request(0, 0.0, "prime")] + [
                               w.Request(1 + i, lead + i, "warm") for i in range(10)],) * 2):
        got = p_simulator.Simulator(spec, seed=0, jitter=jitter).run(make(p_workload))
        want = list(r_simulator.Simulator(ref_spec, seed=0, jitter=jitter).run(
            ref_make(r_workload)))
        assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    if jitter == 0.0:
        cold = p_simulator.Simulator(spec, seed=0, jitter=0.0).run(p_workload.cold_probe())
        primed = p_simulator.Simulator(spec, seed=0, jitter=0.0).run(
            [p_workload.Request(0, 0.0, "prime"), p_workload.Request(1, lead, "warm")])
        assert cold[0].cold and not primed[-1].cold
        assert cold[0].response_s == \
            p_container.cold_start_breakdown(spec).total_s + primed[-1].response_s
