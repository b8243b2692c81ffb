"""The port's CNN payloads (SqueezeNet v1.0, ResNet-18, ResNeXt-50) against
``repro.models.cnn`` on the same weights and images, on the CPU.

Weights come from the reference's init, then numpy, then
``from_reference``.  Both inits fold BatchNorm to scale 1 and bias 0, which
would hide a BatchNorm dropped or broadcast on the wrong axis, so every BN
scale and bias is redrawn (U(0.5, 1.5) and N(0, 0.1)) in the numpy tree
that both sides take.  Images are numpy-seeded and random (a network with no
conv bias and BatchNorm bias 0 maps all-zero images to zero logits), NHWC
for the reference and transposed to NCHW for the port.  64 px and 57 px
cover both kinds of XLA "SAME" padding at stride 2: at 64 the stem pads
(2, 3) and the stride-2 block convs (0, 1); at 57, (3, 3) and (1, 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import PAPER_MODELS
from repro.models import cnn as ref_cnn
from repro.models import common as ref_common
from repro_torch.configs import registry
from repro_torch.models import api, cnn, common
from repro_torch.models.convert import from_reference

VARIANTS = ["squeezenet", "resnet18", "resnext50"]
# float32 on both sides, the same algorithm, sums in another order: the
# logits agree to about 1e-6 relative L2 here
REL_TOL = 1e-5
# These random networks give every image nearly the same logits: the part
# that differs from image to image (the logits less their batch mean) is
# about 5% of the whole.  It is held on its own, so that a mix-up of the
# images in a batch fails; the same sum-order error is about 20 times
# larger against it (1e-5 to 1.5e-5 here).
CENTRED_TOL = 1e-4
# and that part must be there at all
MIN_PER_IMAGE_SHARE = 1e-2


@pytest.fixture(scope="module")
def weights():
    """variant -> (reference params, port params): one draw each, converted."""
    out = {}
    for name in VARIANTS:
        cfg = registry.get(name).smoke
        ref = ref_cnn.init_params(jax.random.PRNGKey(0), PAPER_MODELS[name].smoke)
        tree = _redraw_bn(jax.tree_util.tree_map(np.asarray, ref), np.random.default_rng(3))
        out[name] = (jax.tree_util.tree_map(jnp.asarray, tree),
                     from_reference(tree, cfg, "cpu"))
    return out


def _redraw_bn(tree, rng):
    """``tree`` with every folded BatchNorm's scale drawn from U(0.5, 1.5)
    and its bias from N(0, 0.1)."""
    if isinstance(tree, list):
        return [_redraw_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias"}:
        shape = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, shape).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, shape).astype(np.float32)}
    return {k: _redraw_bn(v, rng) for k, v in tree.items()}


def _images(n, size, seed=0):
    """(NHWC for the reference, NCHW for the port) of the same pixels."""
    x = np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("name", VARIANTS)
def test_cnn_configs_equal_the_reference(name, which):
    ours = getattr(registry.get(name), which)
    assert dataclasses.asdict(ours) == dataclasses.asdict(getattr(PAPER_MODELS[name], which))
    assert registry.get(name).source == PAPER_MODELS[name].source


def test_registry_keeps_the_language_models_apart():
    assert set(registry.PAPER_MODELS) == set(VARIANTS)
    assert not set(registry.ARCHS) & set(VARIANTS)
    assert registry.ALL == {**registry.ARCHS, **registry.PAPER_MODELS}


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,k,s,want", [
    (224, 7, 2, (2, 3)),    # ResNet stem at 224
    (56, 3, 2, (0, 1)),     # stride-2 block conv at 56
    (57, 7, 2, (3, 3)),     # the stem at 57
    (15, 3, 2, (1, 1)),     # a block conv at 15
    (56, 1, 2, (0, 0)),     # 1x1/2 projection
    (13, 3, 1, (1, 1)),     # stride 1 is symmetric
])
def test_same_pad_is_xlas(n, k, s, want):
    assert cnn.same_pad(n, k, s) == want
    assert tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == want


@pytest.mark.parametrize("stride,size", [(1, 9), (2, 9), (2, 8)])
def test_grouped_conv_matches_xla(stride, size):
    """groups=32: HWIO (3,3,cmid/32,cmid) permuted to OIHW splits channels
    as XLA's feature_group_count does."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, size, size, 64)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 64)).astype(np.float32)
    want = ref_cnn.conv2d(jnp.asarray(w), jnp.asarray(x), stride=stride, groups=32)
    got = cnn.conv2d(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
                     torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride, groups=32)
    assert _rel_l2(got.permute(0, 2, 3, 1), want) < REL_TOL


def test_maxpool_with_pad_equals_the_reference_zero_pad():
    x = np.maximum(np.random.default_rng(2).standard_normal((1, 15, 15, 8)), 0).astype(np.float32)
    want = ref_cnn.maxpool(jnp.pad(jnp.asarray(x), [(0, 0), (1, 1), (1, 1), (0, 0)]), 3, 2)
    got = cnn.maxpool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, pad=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANTS)
def test_param_bytes_equal_the_reference(weights, name):
    ref, params = weights[name]
    assert common.param_bytes(params) == ref_common.param_bytes(ref)
    assert common.count_params(params) == ref_common.count_params(ref)


@pytest.mark.parametrize("name", VARIANTS)
def test_seeded_init_has_the_converted_tree(weights, name):
    _, converted = weights[name]
    cfg = registry.get(name).smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), converted)
    assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(params))


def test_convert_permutes_conv_weights_to_oihw(weights):
    ref, params = weights["resnext50"]
    grouped = params["blocks"][0]["conv2"]
    assert grouped.shape == (128, 4, 3, 3) and grouped.is_contiguous()
    np.testing.assert_array_equal(grouped.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(ref["blocks"][0]["conv2"]))
    np.testing.assert_array_equal(params["fc"]["w"].numpy(), np.asarray(ref["fc"]["w"]))
    assert params["bn1"]["scale"].shape == (64,)
    for key in ("scale", "bias"):
        np.testing.assert_array_equal(params["blocks"][0]["bn2"][key].numpy(),
                                      np.asarray(ref["blocks"][0]["bn2"][key]))
    assert params["bn1"]["scale"].std() > 0.1      # redrawn, not the init's ones


def test_language_model_entry_points_refuse_the_cnn_family():
    cfg = registry.get("squeezenet").smoke
    with pytest.raises(ValueError, match="cnn"):
        api.prefill({}, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cfg)
    with pytest.raises(ValueError, match="cnn"):
        api.decode_step({}, {}, torch.zeros((1,), dtype=torch.long), 0, cfg)
    with pytest.raises(ValueError, match="cnn"):
        api.init_cache(cfg, 1, 8, device="cpu")


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 57])
@pytest.mark.parametrize("name", VARIANTS)
def test_forward_and_predict_match_the_reference(weights, name, size):
    ref, params = weights[name]
    ref_cfg = PAPER_MODELS[name].smoke.replace(image_size=size)
    cfg = registry.get(name).smoke.replace(image_size=size)
    nhwc, nchw = _images(3, size, seed=size)
    want = np.asarray(jax.jit(lambda p, x: ref_cnn.forward(p, x, ref_cfg))(ref, nhwc))
    got = cnn.forward(params, nchw, cfg)
    assert got.shape == (3, cfg.num_classes) and got.dtype == torch.float32
    assert np.abs(want).max() > 0
    assert _rel_l2(got, want) < REL_TOL
    centred, want_centred = got - got.mean(0), want - want.mean(0)
    assert np.linalg.norm(want_centred) > MIN_PER_IMAGE_SHARE * np.linalg.norm(want)
    assert _rel_l2(centred, want_centred) < CENTRED_TOL
    np.testing.assert_array_equal(cnn.predict(params, nchw, cfg).numpy(),
                                  np.asarray(ref_cnn.predict(ref, jnp.asarray(nhwc), ref_cfg)))
