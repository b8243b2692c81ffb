"""The port's partition rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), leaf by leaf, without a mesh.

The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so a
``SimpleNamespace`` stands in for the mesh on both sides, and the shapes
come from ``jax.eval_shape`` and the port's meta tensors, with no memory.
The reference stacks each layer list on a leading axis; a port leaf is one
layer, so the reference's spec is compared with its layer entry dropped, for
every layer of the port's list.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCHS
from repro.launch import sharding as ref_sharding
from repro.models import api as ref_api
from repro.train import optimizer as ref_opt
from repro_torch.configs import registry
from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.train import optimizer

MESHES = {"1x2": {"data": 1, "model": 2}, "2x1": {"data": 2, "model": 1},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "1x8": {"data": 1, "model": 8}, "2x4": {"data": 2, "model": 4},
          "4x4": {"data": 4, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CASES = [(arch, size, mesh) for arch in ARCHS for size in ("smoke", "full")
         for mesh in MESHES]


def _mesh(name: str) -> SimpleNamespace:
    shape = MESHES[name]
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _cfgs(arch: str, size: str):
    spec, port = ARCHS[arch], registry.get(arch)
    return (spec.smoke, port.smoke) if size == "smoke" else (spec.config, port.config)


@functools.lru_cache(maxsize=None)
def _abstract(arch: str, size: str):
    ref_cfg, cfg = _cfgs(arch, size)
    return ref_api.abstract_params(ref_cfg), api.abstract_params(cfg)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _ref_flat(tree) -> dict:
    """path -> spec of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in path): spec for path, spec in flat}


def _port_flat(tree, keys=(), stacked=False):
    """(path, leaf, stacked) of a port tree in leaf order; a layer list's
    index is left out of the path, as the reference stacks the list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_flat(v, keys + (str(k),), stacked)
    elif isinstance(tree, list):
        stack = bool(keys) and keys[-1] in sharding.STACKED
        for i, v in enumerate(tree):
            yield from _port_flat(v, keys if stack else keys + (str(i),), stacked or stack)
    else:
        yield keys, tree, stacked


def _pad(spec, n: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


def _same_as_reference(port_specs, port_abs, ref_specs, mesh, ref_tp=None) -> int:
    """Every port leaf's spec equals the reference's at its path (the layer
    entry dropped where the reference stacks).  Where the reference's FSDP
    put "data" on the layer axis itself (its largest divisible dim), which
    a one-layer port leaf has not, the port's spec must be the reference's
    FSDP rule with that axis out of the candidates: ``_add_fsdp`` on the
    reference's tensor-parallel spec and the stacked shape with a layer
    axis of 1, which divides no data axis.  -> leaves compared."""
    want = _ref_flat(ref_specs)
    tp = _ref_flat(ref_tp) if ref_tp is not None else {}
    specs = list(_port_flat(port_specs))
    leaves = list(_port_flat(port_abs))
    assert len(specs) == len(leaves)
    for (path, spec, stacked), (lpath, leaf, _) in zip(specs, leaves):
        assert path == lpath
        n = leaf.dim()
        ref = _pad(want[path], n + stacked)
        if stacked and ref[0] == "data" and ref_tp is not None:
            ref = _pad(ref_sharding._add_fsdp(tp[path], (1, *leaf.shape), mesh), n + 1)
        if stacked:
            assert ref[0] is None, (path, ref)
            ref = ref[1:]
        assert _pad(spec, n) == ref, (path, spec, ref)
    return len(specs)


@pytest.mark.parametrize("arch,size,mesh", CASES)
def test_param_opt_and_cache_specs_equal_the_reference(arch, size, mesh):
    ref_cfg, cfg = _cfgs(arch, size)
    m = _mesh(mesh)
    ref_abs, port_abs = _abstract(arch, size)
    ref_tp = ref_sharding.param_pspecs(ref_abs, ref_cfg, m)
    for fsdp in (False, True):
        ref_specs = ref_sharding.param_pspecs(ref_abs, ref_cfg, m, fsdp=fsdp)
        specs = sharding.param_pspecs(port_abs, cfg, m, fsdp=fsdp)
        assert _same_as_reference(specs, port_abs, ref_specs, m, ref_tp if fsdp else None) > 0
        # moments: the reference's {"mu": params, "nu": params, "step"}
        ref_opt_specs = _ref_flat(ref_sharding.opt_pspecs(
            jax.eval_shape(ref_opt.AdamW().init, ref_abs), ref_specs))
        opt_specs = sharding.opt_pspecs(optimizer.AdamW().init(port_abs), specs)
        for moment in ("mu", "nu"):
            mu_ref = {path[1:]: v for path, v in ref_opt_specs.items() if path[0] == moment}
            assert mu_ref == _ref_flat(ref_sharding.param_pspecs(ref_abs, ref_cfg, m,
                                                                  fsdp=fsdp))
            assert opt_specs[moment] == sharding.spec_leaves(specs)
        assert tuple(ref_opt_specs[("step",)]) == opt_specs["step"] == ()
    # caches keep the reference's stacked layout: equal, on shapes where the
    # reference's search for the batch dim cannot take the layer axis for it
    for batch in (1, 2, 4, 32):
        ref_cache = _unambiguous(jax.eval_shape(lambda b=batch: ref_api.init_cache(ref_cfg, b, 64)))
        cache = api.init_cache(cfg, batch, 64, device="meta")
        want = _ref_flat(ref_sharding.cache_pspecs(ref_cache, ref_cfg, m, batch=batch))
        got = sharding.cache_pspecs(cache, cfg, m, batch=batch)
        flat = list(_port_flat(got))
        assert len(flat) == len(want)
        for path, spec, _ in flat:
            assert tuple(spec) == tuple(want[path]), (batch, path)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_replicated_cache_specs_equal_the_reference(arch):
    """``cache_pspecs(use_model=False)``, the replicated-weights prefill's
    cache (whole over "model"), leaf by leaf against the reference's."""
    for size in ("smoke", "full"):
        ref_cfg, cfg = _cfgs(arch, size)
        for mesh in ("2x2", "1x4", "2x4", "16x16", "2x16x16"):
            m = _mesh(mesh)
            for batch in (1, 2, 32):
                ref_cache = _unambiguous(jax.eval_shape(
                    lambda b=batch: ref_api.init_cache(ref_cfg, b, 64)))
                want = _ref_flat(ref_sharding.cache_pspecs(ref_cache, ref_cfg, m, batch=batch,
                                                           use_model=False))
                got = list(_port_flat(sharding.cache_pspecs(
                    api.init_cache(cfg, batch, 64, device="meta"), cfg, m, batch=batch,
                    use_model=False)))
                assert len(got) == len(want)
                for path, spec, _ in got:
                    assert tuple(spec) == tuple(want[path]), (mesh, batch, path)
                    assert "model" not in str(spec), (mesh, batch, path)


def _unambiguous(cache):
    """The reference cache's shapes with each stacked leaf's layer axis
    resized to a prime no batch or axis equals: the reference finds the
    batch dim from the shape and takes the layer axis for it when the batch
    equals the layer count; the port knows its layout
    (``sharding._batch_dim``).  The rules never cut the layer axis
    otherwise, so the specs are the reference's for its own caches."""
    def fix(path, leaf):
        if any(_key(k) == "extra" for k in path):
            return leaf
        return jax.ShapeDtypeStruct((10007, *leaf.shape[1:]), leaf.dtype)
    return jax.tree_util.tree_map_with_path(fix, cache)


def test_a_cache_whose_batch_equals_its_layer_count_is_cut_by_rows():
    """deepseek's smoke config has 2 layers: at batch 2 over 2 data ranks the
    batch dim is cut, never the layer axis."""
    cfg = registry.get("deepseek-7b").smoke
    cache = api.init_cache(cfg, 2, 16, device="meta")
    specs = sharding.cache_pspecs(cache, cfg, _mesh("2x2"), batch=2)
    assert specs["k"] == specs["v"] == (None, "data", None, "model", None)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_input_specs_equal_the_reference(mesh):
    m = _mesh(mesh)
    for shape in ((1, 16), (2, 16), (4, 8), (8, 64, 32), (32, 4), (512, 2), (6, 3)):
        assert sharding.batch_pspec(shape, m) == tuple(ref_sharding.batch_pspec(shape, m))
    inputs = {"tokens": torch.zeros((32, 16)), "labels": torch.zeros((32, 16)),
              "patch_embeds": torch.zeros((32, 4, 8))}
    ref = ref_sharding.input_pspecs({k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
                                     for k, v in inputs.items()}, m)
    assert sharding.input_pspecs(inputs, m) == {k: tuple(v) for k, v in ref.items()}


def test_shard_and_gather_are_inverse_on_one_rank():
    """On a one-rank (1, 1) mesh every spec is replicated: the shard is the
    whole tensor and the gather gives it back."""
    m = SimpleNamespace(shape={"data": 1, "model": 1}, axis_names=("data", "model"),
                        device=torch.device("cpu"), size=lambda axes: 1,
                        index=lambda axes: 0)
    cfg = registry.get("deepseek-7b").smoke
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = sharding.param_pspecs(params, cfg, m, fsdp=True)
    assert all(s == () for s in sharding.spec_leaves(specs))
    local = sharding.shard_tree(params, specs, m)
    assert all(torch.equal(a, b) for a, b in zip(sharding.spec_leaves(local),
                                                 sharding.spec_leaves(params)))


def test_local_shapes_follow_the_specs():
    m = SimpleNamespace(shape={"pod": 2, "data": 2, "model": 4},
                        axis_names=("pod", "data", "model"),
                        size=lambda axes: {"model": 4, "data": 2, "pod": 2}[axes[0]]
                        * (2 if len(axes) > 1 else 1))
    assert sharding.local_shape((8, 12, 16), (("pod", "data"), None, "model"), m) == (2, 12, 4)
    assert sharding.local_shape((8, 12), (), m) == (8, 12)


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "4x4", "16x16"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "qwen3-moe-235b-a22b", "recurrentgemma-9b", "whisper-tiny"])
def test_model_cut_is_the_rules_answer(arch, mesh):
    """What the model code asks (``model_cut`` on a leaf's trailing names and
    whole shape, under the ambient mesh) is the model-axis cut of the
    leaf's spec in ``param_pspecs``, for every leaf of the full config; and
    no mesh, or a model axis of 1, cuts nothing."""
    from repro_torch import shardctx
    cfg = registry.get(arch).config
    m = _mesh(mesh)
    abs_params = api.abstract_params(cfg)
    specs = sharding.param_pspecs(abs_params, cfg, m)
    leaves = [(keys, leaf) for keys, leaf, _ in _port_flat(abs_params)]
    assert len(leaves) == len(sharding.spec_leaves(specs))
    with shardctx.use_mesh(m):
        for (keys, leaf), spec in zip(leaves, sharding.spec_leaves(specs)):
            want = next((d for d, axes in sharding.spec_cuts(spec) if "model" in axes), None)
            assert sharding.model_cut(keys[-3:], tuple(leaf.shape)) == want, keys
    assert sharding.model_cut(("wo", "w"), (4096, 4096)) is None
    with shardctx.use_mesh(_mesh("2x1")):
        assert sharding.model_cut(("wo", "w"), (4096, 4096)) is None


@pytest.mark.parametrize("batched", [False, True])
def test_float32_products_match_the_upcast_product_and_its_gradients(batched):
    """bf16 operands: the float32 output equals the product of the upcast
    operands; the gradients are those of the bf16 product (each operand's
    GEMM in its own dtype), within bf16's rounding of the upcast product's."""
    from repro_torch.models.common import float32_products
    g = torch.Generator().manual_seed(0)
    a_shape, b_shape = ((3, 16, 32), (3, 32, 8)) if batched else ((2, 16, 32), (32, 8))
    a = torch.randn(a_shape, generator=g).bfloat16().requires_grad_()
    b = torch.randn(b_shape, generator=g).bfloat16().requires_grad_()
    y = float32_products(a, b)
    assert y.dtype == torch.float32
    a2, b2 = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
    want = a2 @ b2
    assert torch.equal(y.detach(), want.detach())
    gy = torch.randn(y.shape, generator=g).bfloat16().float()
    y.backward(gy)
    want.backward(gy)
    for got, ref in ((a.grad, a2.grad), (b.grad, b2.grad)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=1e-2, atol=1e-2)
    x, w = torch.randn(4, 8, generator=g), torch.randn(8, 3, generator=g)
    assert torch.equal(float32_products(x, w), x @ w)


def _rank_mesh(name: str, model_index: int) -> SimpleNamespace:
    """A mesh as the rank at ``model_index`` on its model axis sees it."""
    shape = MESHES[name]
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape),
                           size=lambda axes: shape["model"] if axes == "model" else 1,
                           index=lambda axes: model_index if axes == "model" else 0)


@pytest.mark.parametrize("arch,mesh", [("granite-moe-3b-a800m", "16x16"),
                                       ("qwen2.5-32b", "16x16"), ("whisper-tiny", "1x4"),
                                       ("recurrentgemma-9b", "1x2"),
                                       ("qwen3-moe-235b-a22b", "1x8")])
def test_head_spans_cover_the_rules_columns(arch, mesh):
    """``head_span`` on every rank of the model axis: the heads that touch
    the rank's columns of ``wq`` and of ``wo``'s rows (``model_span``,
    the rules' equal chunks), whole exactly where the chunk starts and ends
    on a head boundary; over the ranks the chunks tile the width and the
    spans cover every head, a head shared by two ranks only where a cut
    falls inside it."""
    from repro_torch import shardctx
    cfg = registry.get(arch).config
    hd, m = cfg.resolved_head_dim, MESHES[mesh]["model"]
    for keys, shape in ((("wq", "w"), (cfg.d_model, cfg.q_dim)),
                        (("wo", "w"), (cfg.q_dim, cfg.d_model))):
        covered, cols = [], []
        for r in range(m):
            with shardctx.use_mesh(_rank_mesh(mesh, r)):
                lo, hi = sharding.model_span(keys, shape)
                first, stop, whole = sharding.head_span(keys, shape, hd)
            cols.append((lo, hi))
            assert (first, stop) == (lo // hd, -(-hi // hd))
            assert whole == (lo % hd == 0 and hi % hd == 0) == (cfg.num_heads % m == 0)
            covered.extend(range(first, stop))
        assert cols == [(r * cfg.q_dim // m, (r + 1) * cfg.q_dim // m) for r in range(m)]
        assert set(covered) == set(range(cfg.num_heads))
        assert len(covered) - cfg.num_heads <= (m - 1 if cfg.num_heads % m else 0)


@pytest.mark.parametrize("arch,mesh,batch,want", [
    ("granite-moe-3b-a800m", "1x4", 4, {"k": ("model",)}),     # 2 kv heads over 4
    ("deepseek-7b", "2x2", 1, {"k": ("data",)}),               # batch 1: long-KV
    ("deepseek-7b", "2x1", 1, {"k": ("data", "model")}),       # and kv heads over 1
    ("granite-moe-3b-a800m", "2x4", 1, {"k": ("data", "model")}),  # both axes cut
    ("deepseek-7b", "2x2", 2, {"k": ()}),                      # rows and heads cut
    ("whisper-tiny", "1x4", 4, {"k": ("model",), "xk": ("model",)}),
    ("recurrentgemma-9b", "2x1", 1, {"k": ("data",)}),         # the ring, by slot
    ("recurrentgemma-9b", "1x2", 4, {"k": ()}),                # its window exempts it
])
def test_seq_cut_reads_the_cache_specs(arch, mesh, batch, want):
    """What the model code asks of a cache's sequence (``seq_cut``) is the
    sequence entry of the leaf's spec in ``cache_pspecs``, inside the
    layout the entry points make ambient; () outside it or without a mesh."""
    from repro_torch import shardctx
    cfg = registry.get(arch).smoke
    m = _mesh(mesh)
    cache = api.init_cache(cfg, batch, 64, device="meta")
    specs = sharding.cache_pspecs(cache, cfg, m, batch=batch)
    with shardctx.use_mesh(m):
        assert sharding.seq_cut("k") == ()
        with sharding.use_cache_layout(cache, specs):
            for name, axes in want.items():
                assert sharding.seq_cut(name) == axes
                assert sharding.seq_cut(name.replace("k", "v")) == axes
    with sharding.use_cache_layout(cache, specs):
        assert sharding.seq_cut("k") == ()
