"""Checkpoints cross between the port and the reference, on the CPU: a
reference ``save`` restores in the port equal to ``from_reference`` of the
same tree, and a port ``save`` restores in the reference
(``repro.train.checkpoint.restore``) into the reference's own tree; in
float32 and bfloat16, for a family with stacked layers (deepseek), one with
``units`` and ``extra`` (recurrentgemma's hybrid), and train()'s own
checkpoint."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import api as ref_api
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.train import checkpoint
from repro_torch.train.loop import train

CASES = [("deepseek-7b", "float32"), ("deepseek-7b", "bfloat16"),
         ("recurrentgemma-9b", "float32"), ("recurrentgemma-9b", "bfloat16")]


def _trees(arch: str, dtype: str):
    """(the reference's params as JAX arrays, the config of both sides) in
    ``dtype``."""
    ref_cfg = ARCHS[arch].smoke.replace(param_dtype=dtype, compute_dtype=dtype)
    cfg = registry.get(arch).smoke.replace(param_dtype=dtype, compute_dtype=dtype)
    tree = ref_api.init_params(jax.random.PRNGKey(3), ref_cfg)
    return tree, cfg


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, arch, dtype):
    tree, cfg = _trees(arch, dtype)
    path = str(tmp_path / "ref")
    ref_ckpt.save(path, {"params": tree}, step=7, extra={"note": "ref"})
    like = {"params": convert.to_reference(
        convert.from_reference(jax.tree_util.tree_map(np.array, tree), cfg, "cpu"), cfg)}
    got, step, extra = checkpoint.restore(path, like)
    assert step == 7 and extra == {"note": "ref"}
    want = convert.from_reference(jax.tree_util.tree_map(np.array, tree), cfg, "cpu")
    assert _equal(convert.from_reference(got["params"], cfg, "cpu"), want)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, arch, dtype):
    tree, cfg = _trees(arch, dtype)
    params = convert.from_reference(jax.tree_util.tree_map(np.array, tree), cfg, "cpu")
    path = str(tmp_path / "port")
    checkpoint.save(path, {"params": convert.to_reference(params, cfg)}, step=5,
                    extra={"note": "port"})
    restored, step, extra = ref_ckpt.restore(path, {"params": tree})
    assert step == 5 and extra == {"note": "port"}
    got, want = jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))


@pytest.mark.parametrize("arch", ["deepseek-7b", "recurrentgemma-9b"])
def test_the_manifest_names_the_reference_tree(tmp_path, arch):
    """The port writes the manifest the reference writes for the same tree:
    its ``treedef``, leaf count and dtypes."""
    tree, cfg = _trees(arch, "bfloat16")
    params = convert.from_reference(jax.tree_util.tree_map(np.array, tree), cfg, "cpu")
    checkpoint.save(str(tmp_path / "port"), {"params": convert.to_reference(params, cfg)})
    ref_ckpt.save(str(tmp_path / "ref"), {"params": tree})
    port, ref = ((json.loads((tmp_path / f"{n}.json").read_text())) for n in ("port", "ref"))
    assert port == ref


def test_train_checkpoints_in_the_reference_format(tmp_path):
    cfg = registry.get("rwkv6-1.6b").smoke
    path = str(tmp_path / "run")
    train(cfg, steps=4, batch=2, seq=8, verbose=False, ckpt_path=path, device="cpu")
    like = {"params": jax.tree_util.tree_map(
        jnp.asarray, ref_api.init_params(jax.random.PRNGKey(0), ARCHS["rwkv6-1.6b"].smoke))}
    restored, step, _ = ref_ckpt.restore(path, like)
    assert step == 4
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(restored))
    port, _, _ = checkpoint.restore(path, like)
    for g, w in zip(jax.tree_util.tree_leaves(restored), checkpoint._flatten(port)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def _none_trees():
    """Trees with ``None`` nodes, as numpy leaves: one at the top and one
    nested, with ``None`` inside a list and a dict."""
    return [{"a": None, "b": np.ones(2, np.float32), "c": np.zeros(3, np.float32)},
            {"v": np.arange(4, dtype=np.int32),
             "w": None,
             "x": [np.full((2, 2), 2.5, np.float32), None,
                   {"y": np.arange(3, dtype=np.float32), "z": None}]}]


def _names(path) -> list:
    return sorted(np.load(path + ".npz").files)


@pytest.mark.parametrize("case", [0, 1])
def test_a_reference_checkpoint_with_none_nodes_restores_in_the_port(tmp_path, case):
    tree = _none_trees()[case]
    path = str(tmp_path / "ref")
    ref_ckpt.save(path, jax.tree_util.tree_map(jnp.asarray, tree), step=2)
    arrays = jax.tree_util.tree_leaves(tree)
    meta = json.loads((tmp_path / "ref.json").read_text())
    assert meta["n"] == len(arrays) and _names(path) == sorted(f"a{i}" for i in range(len(arrays)))
    got, step, _ = checkpoint.restore(path, tree)
    assert step == 2
    assert checkpoint.treedef(got) == checkpoint.treedef(tree)
    flat = checkpoint._flatten(got)
    assert len(flat) == len(arrays)
    for g, w in zip(flat, arrays):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.numpy().dtype == w.dtype


@pytest.mark.parametrize("case", [0, 1])
def test_a_port_checkpoint_with_none_nodes_restores_in_the_reference(tmp_path, case):
    tree = _none_trees()[case]
    path = str(tmp_path / "port")
    checkpoint.save(path, jax.tree_util.tree_map(torch.from_numpy, tree), step=3)
    ref_ckpt.save(str(tmp_path / "ref"), jax.tree_util.tree_map(jnp.asarray, tree), step=3)
    port, ref = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "ref"))
    assert port == ref
    arrays = jax.tree_util.tree_leaves(tree)
    assert port["n"] == len(arrays) and _names(path) == _names(str(tmp_path / "ref"))
    restored, step, _ = ref_ckpt.restore(path, tree)
    assert step == 3
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(tree)
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(arrays)
    for g, w in zip(got, arrays):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)
