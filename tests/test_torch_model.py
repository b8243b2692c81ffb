"""The port's model (dense deepseek smoke config, float32) against the
reference package on the same weights and tokens, on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro_torch.configs import deepseek_7b, registry
from repro_torch.models import api, common, layers, transformer
from repro_torch.models.convert import from_reference
from repro_torch.serving.engine import bucket_len

REF_CFG = ARCHS["deepseek-7b"].smoke
CFG = deepseek_7b.SMOKE
TOL = 1e-5   # float32, same algorithm; sums in another order


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params): one draw, converted."""
    ref_params = ref_api.init_params(jax.random.PRNGKey(0), REF_CFG)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_params, from_reference(np_params, CFG, device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------

def test_model_config_has_the_reference_fields():
    assert ([f.name for f in dataclasses.fields(common.ModelConfig)] ==
            [f.name for f in dataclasses.fields(ref_common.ModelConfig)])


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_configs_equal_the_reference(arch, which):
    ours = getattr(registry.get(arch), which)
    ref = getattr(ARCHS[arch], which)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.pdt == getattr(torch, str(ref.pdt))
    spec, ref_spec = registry.get(arch), ARCHS[arch]
    assert (spec.source, spec.long_strategy, spec.long_window, spec.notes) == (
        ref_spec.source, ref_spec.long_strategy, ref_spec.long_window, ref_spec.notes)


def test_registry_lists_the_reference_archs_in_its_order():
    assert list(registry.ARCHS) == list(ARCHS)


def test_registry_names_the_queue_for_unported_archs():
    """Every reference arch is ported; an unknown id raises ``KeyError``
    naming the ones there are."""
    for arch in ARCHS:
        assert registry.get(arch).arch_id == arch
    with pytest.raises(KeyError, match="deepseek-7b"):
        registry.get("no-such-arch")


def test_moe_and_other_families_raise_not_implemented():
    """Every reference family is dispatched; an unknown one raises
    ``NotImplementedError`` naming the ones there are."""
    for family in ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "cnn"):
        assert api.module_for(CFG.replace(family=family)) is not None
    with pytest.raises(NotImplementedError, match="hybrid"):
        api.init_params(CFG.replace(family="diffusion"), torch.Generator().manual_seed(0),
                        "cpu")


# ----------------------------------------------------------------------
# common
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    want = ref_common.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kind)
    got = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    _close(got, want)


def test_apply_rope_matches_per_row_and_shared_positions():
    x = np.random.default_rng(2).standard_normal((3, 7, 4, 32)).astype(np.float32)
    for pos in (np.arange(7)[None], np.array([[5], [0], [41]]) + np.zeros((3, 7), int)):
        want = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
        _close(got, want)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations_match(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(common.activation(name)(torch.from_numpy(x)),
           ref_common.activation(name)(jnp.asarray(x)))


def test_converted_params_keep_every_leaf(weights):
    ref_params, params = weights
    assert common.count_params(params) == ref_common.count_params(ref_params)
    assert common.param_bytes(params) == ref_common.param_bytes(ref_params)
    assert len(params["layers"]) == CFG.num_layers
    np.testing.assert_array_equal(params["layers"][1]["attn"]["wq"]["w"].numpy(),
                                  np.asarray(ref_params["layers"]["attn"]["wq"]["w"][1]))


def test_convert_carries_bf16_bits():
    w = jnp.asarray(np.random.default_rng(3).standard_normal((8, 4)), jnp.bfloat16)
    cfg = CFG.replace(num_layers=1)
    tree = {"embed": {"embedding": np.asarray(w)}, "final_norm": {"scale": np.ones(4)},
            "layers": {"ln1": {"scale": np.ones((1, 4))}}}
    got = from_reference(tree, cfg, device="cpu")["embed"]["embedding"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(w, np.float32))


def test_seeded_init_has_the_reference_tree_shapes():
    ref_shapes = jax.eval_shape(lambda: ref_api.init_params(jax.random.PRNGKey(0), REF_CFG))
    params = api.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert common.count_params(params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(ref_shapes))
    assert params["layers"][0]["mlp"]["wi"]["w"].shape == (CFG.d_model, CFG.d_ff)
    again = api.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["embed"]["unembed"]["w"], again["embed"]["unembed"]["w"])


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 16])
def test_attention_chunked_matches_sdpa(window):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 64, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 64, 2, 32)).astype(np.float32))
    pos = torch.arange(64)
    want = layers.sdpa(q, k, v, layers.causal_window_mask(pos, pos, window))
    got = layers.attention_chunked(q, k, v, pos, pos, window, chunk=16)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_causal_window_mask_matches():
    qp, kp = np.arange(12), np.arange(12)
    for window in (0, 4):
        np.testing.assert_array_equal(
            layers.causal_window_mask(torch.from_numpy(qp), torch.from_numpy(kp), window).numpy(),
            np.asarray(ref_layers.causal_window_mask(jnp.asarray(qp), jnp.asarray(kp), window)))


# ----------------------------------------------------------------------
# prefill and decode against the reference
# ----------------------------------------------------------------------

def test_forward_logits_match(weights):
    ref_params, params = weights
    toks = _tokens((2, 9), 5)
    want, _ = ref_transformer.forward(ref_params, jnp.asarray(toks), REF_CFG)
    got, _ = transformer.forward(params, torch.from_numpy(toks), CFG)
    _close(got, want)


@pytest.mark.parametrize("last_pos", [None, 6, "rows"])
def test_prefill_logits_and_cache_match(weights, last_pos):
    ref_params, params = weights
    toks = _tokens((3, 12), 6)
    ref_last = t_last = None
    if last_pos == "rows":
        rows = np.array([11, 3, 7])
        ref_last, t_last = jnp.asarray(rows, jnp.int32), torch.from_numpy(rows)
    elif last_pos is not None:
        ref_last, t_last = jnp.int32(last_pos), last_pos
    want, ref_cache = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, REF_CFG,
                                      cache_len=20, last_pos=ref_last)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)}, CFG,
                             cache_len=20, last_pos=t_last)
    _close(got, want)
    assert cache["k"].shape == ref_cache["k"].shape
    _close(cache["k"], ref_cache["k"])
    _close(cache["v"], ref_cache["v"])


def test_prefill_writes_a_preallocated_cache_in_place(weights):
    _, params = weights
    toks = torch.from_numpy(_tokens((2, 8), 7))
    want, fresh = api.prefill(params, {"tokens": toks}, CFG, cache_len=16)
    cache = api.init_cache(CFG, 2, 16, device="cpu")
    for t in cache.values():
        t.fill_(7.0)   # stale contents past the prompt must be zeroed
    got, same = api.prefill(params, {"tokens": toks}, CFG, cache_len=16, cache=cache)
    assert same is cache
    assert torch.equal(got, want)
    assert torch.equal(cache["k"], fresh["k"]) and torch.equal(cache["v"], fresh["v"])


def test_decode_scalar_position_matches(weights):
    ref_params, params = weights
    toks = _tokens((2, 7), 8)
    _, ref_cache = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, REF_CFG,
                                   cache_len=16)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)}, CFG, cache_len=16)
    nxt = _tokens((2,), 9)
    for pos in range(7, 10):
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                              jnp.int32(pos), REF_CFG)
        got, cache = api.decode_step(params, cache, torch.from_numpy(nxt), pos, CFG)
        _close(got, want)
        _close(cache["k"], ref_cache["k"])
        nxt = np.array(jnp.argmax(want, -1))


def test_decode_per_row_positions_match(weights):
    ref_params, params = weights
    toks = _tokens((3, 10), 10)
    _, ref_cache = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, REF_CFG,
                                   cache_len=24)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)}, CFG, cache_len=24)
    pos = np.array([4, 10, 7])
    nxt = _tokens((3,), 11)
    for _ in range(3):
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                              jnp.asarray(pos, jnp.int32), REF_CFG)
        got, cache = api.decode_step(params, cache, torch.from_numpy(nxt),
                                     torch.from_numpy(pos), CFG)
        _close(got, want)
        _close(cache["v"], ref_cache["v"])
        nxt, pos = np.array(jnp.argmax(want, -1)), pos + 1


@pytest.mark.parametrize("per_row", [False, True])
def test_windowed_decode_matches_band_slice(per_row):
    """attention_window=8 against a 24-long cache: the scalar branch attends
    to the live band only (s > 2*window), the per-row branch masks."""
    ref_cfg, cfg = REF_CFG.replace(attention_window=8), CFG.replace(attention_window=8)
    ref_params = ref_api.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = from_reference(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    toks = _tokens((2, 12), 12)
    want, ref_cache = ref_api.prefill(ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg,
                                      cache_len=24)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg, cache_len=24)
    _close(got, want)
    nxt = _tokens((2,), 13)
    for pos in range(12, 15):
        rp, tp = ((jnp.asarray([pos, pos], jnp.int32), torch.tensor([pos, pos]))
                  if per_row else (jnp.int32(pos), pos))
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache, jnp.asarray(nxt), rp,
                                              ref_cfg)
        got, cache = api.decode_step(params, cache, torch.from_numpy(nxt), tp, cfg)
        _close(got, want)


@pytest.mark.parametrize("s", [5, 10, 13])
def test_bucketed_prefill_last_logits_bit_exact(weights, s):
    """Right-padding a prompt to its bucket and reading logits at ``len-1``
    is bit-identical to the exact-length prefill in the port, too."""
    _, params = weights
    prompt = torch.from_numpy(_tokens((1, s), 14))
    exact, _ = api.prefill(params, {"tokens": prompt}, CFG, cache_len=32)
    padded = torch.nn.functional.pad(prompt, (0, bucket_len(s) - s))
    bucketed, _ = api.prefill(params, {"tokens": padded}, CFG, cache_len=32,
                              last_pos=s - 1)
    assert torch.equal(exact, bucketed)
