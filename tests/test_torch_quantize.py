"""The port's weight-only int8 quantization (``serving/quantize.py``) against
the reference's ``repro.serving.quantize``, on the CPU.

On the same tree (the reference's layer-stacked leaves, carried into torch
leaf for leaf) ``q`` and ``scale`` equal the reference's bit for bit: both
round half to even.  The port's own model trees, a list of per-layer trees
where the reference stacks, quantize to the reference's stack layer for
layer (one scale shared by the layers), with the reference's stats, and the
model still predicts as the reference's test asks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import api as ref_api
from repro.serving import quantize as ref_quantize
from repro_torch.configs import registry
from repro_torch.models import api, common
from repro_torch.models.convert import from_reference
from repro_torch.serving import quantize

ARCHS_Q = ("deepseek-7b", "granite-moe-3b-a800m", "recurrentgemma-9b", "whisper-tiny")


def _to_torch(tree):
    """The reference's tree with each array as a torch tensor, the layout
    kept (bfloat16 through its bits)."""
    def leaf(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return jax.tree_util.tree_map(leaf, tree)


def _to_numpy(tree):
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    return jax.tree_util.tree_map(leaf, tree)


def _ref_params(arch, dtype):
    cfg = ARCHS[arch].smoke.replace(param_dtype=dtype)
    return ref_api.init_params(jax.random.PRNGKey(0), cfg)


def _assert_same_tree(got, want):
    gl, gd = jax.tree_util.tree_flatten(_to_numpy(got))
    wl, wd = jax.tree_util.tree_flatten(want)
    assert gd == wd
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS_Q)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_equals_the_reference_bit_for_bit(arch, dtype):
    ref_params = _ref_params(arch, dtype)
    want, want_stats = ref_quantize.quantize_params(ref_params)
    got, stats = quantize.quantize_params(_to_torch(ref_params))
    _assert_same_tree(got, want)
    assert stats == want_stats
    for dt, ref_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        _assert_same_tree(quantize.dequantize_params(got, dt),
                          ref_quantize.dequantize_params(want, ref_dt))


@pytest.mark.parametrize("arch", ARCHS_Q)
def test_quantization_error_equals_the_reference(arch):
    ref_params = _ref_params(arch, "float32")
    assert quantize.quantization_error(_to_torch(ref_params)) == \
        ref_quantize.quantization_error(ref_params)


def test_round_half_to_even_as_the_reference():
    """A column whose largest magnitude is 127 has scale 1, so w/scale lands
    on halves exactly: they round to the even neighbour on both sides."""
    w = np.array([[127.0, -127.0], [0.5, -0.5], [1.5, 2.5], [-1.5, -2.5], [126.5, -126.5]],
                 np.float32)
    want = ref_quantize._quantize_leaf(jnp.asarray(w))
    got = quantize._quantize_leaf(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["q"][:, 0].tolist() == [127, 0, 2, -2, 126]


def test_zero_column_keeps_the_floor_scale():
    w = np.zeros((3, 2), np.float32)
    w[:, 1] = [1.0, -2.0, 0.25]
    want = ref_quantize._quantize_leaf(jnp.asarray(w))
    got = quantize._quantize_leaf(torch.from_numpy(w))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))


def _restack(tree):
    """The port's quantized model tree in the reference's layout: each list
    of ``quantize.STACKED`` stacked on a leading layer axis, the layers'
    shared scale given that axis (of length 1, as the reference keeps it)."""
    def stack(layers):
        first = layers[0]
        if set(first) == {"q", "scale"}:
            assert all(lp["scale"] is first["scale"] for lp in layers)
            return {"q": torch.stack([lp["q"] for lp in layers]),
                    "scale": first["scale"][None]}
        if isinstance(first, dict):
            return {k: stack([lp[k] for lp in layers]) for k in first}
        return torch.stack(layers)

    return {k: stack(v) if k in quantize.STACKED and isinstance(v, list) else v
            for k, v in tree.items()}


ARCHS_TREE = (*ARCHS_Q, "rwkv6-1.6b", "llava-next-mistral-7b")


@pytest.mark.parametrize("arch", ARCHS_TREE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_ports_model_tree_quantizes_as_the_reference_stack(arch, dtype):
    """``from_reference``'s tree, a list of per-layer trees where the
    reference stacks: every layer's ``q`` is its slice of the reference's
    stacked ``q``, the shared scale is the reference's (maxima over every
    layer), bit for bit, and the stats are the reference's."""
    cfg = registry.get(arch).smoke.replace(param_dtype=dtype)
    ref_params = _ref_params(arch, dtype)
    params = from_reference(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    want, want_stats = ref_quantize.quantize_params(ref_params)
    got, stats = quantize.quantize_params(params)
    _assert_same_tree(_restack(got), want)
    assert stats == want_stats
    _assert_same_tree(_restack(quantize.dequantize_params(got, torch.float32)),
                      ref_quantize.dequantize_params(want, jnp.float32))


@pytest.mark.parametrize("arch", ["deepseek-7b", "recurrentgemma-9b"])
def test_the_ports_model_tree_quantizes_the_same_leaves_and_still_predicts(arch):
    """The port's tree, one leaf per layer, keeps the reference's key
    names: every quantizable reference leaf is quantized once over the
    layers, as the reference's stack is.  On the reference's own test
    tokens the int8 model's logits are the reference's int8 model's, within
    1e-5, and its top-1 agreement with the float model is the reference's
    and above 0.9 (the reference's own test of its quantization)."""
    cfg = registry.get(arch).smoke
    ref_cfg = ARCHS[arch].smoke
    ref_params = _ref_params(arch, "float32")
    params = from_reference(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    qt, stats = quantize.quantize_params(params)
    ref_qt, ref_stats = ref_quantize.quantize_params(ref_params)
    assert stats == ref_stats
    assert stats["bytes_before"] == common.param_bytes(params)
    ref_toks = jax.random.randint(jax.random.PRNGKey(0), (2, 16), 0, cfg.vocab_size)
    ref_mod = ref_api.module_for(ref_cfg)
    ref_want, _ = ref_mod.forward(ref_params, ref_toks, ref_cfg)
    ref_got, _ = ref_mod.forward(ref_quantize.dequantize_params(ref_qt, jnp.float32),
                                 ref_toks, ref_cfg)
    toks = torch.from_numpy(np.asarray(ref_toks).astype(np.int64))
    mod = api.module_for(cfg)
    want, _ = mod.forward(params, toks, cfg)
    got, _ = mod.forward(quantize.dequantize_params(qt, torch.float32), toks, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_got), rtol=1e-5, atol=1e-5)
    agree = (want.argmax(-1) == got.argmax(-1)).float().mean().item()
    ref_agree = float(jnp.mean(jnp.argmax(ref_want, -1) == jnp.argmax(ref_got, -1)))
    assert agree == ref_agree
    assert agree > 0.9
