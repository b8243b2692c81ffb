"""The port's AdamW kernels (K4 ``grad_sumsq``, K5 ``adamw_update``) and its
captured train step (``serving/graphs.py::TrainGraph``).

On the CPU: the kernels' plain versions against the reference's
``global_norm`` and AdamW update on the same leaves, the device-step
schedule and update against the reference step for step, the wrapper's
leaf tables, ``train()`` through ``TrainGraph`` against ``make_train_step``
called directly (bit for bit) and against the reference's jitted ``train``.
On a card (``pytest -m gpu``): K4 and K5 against their plain versions, and
the replayed train step against the uncaptured one, bit for bit.

The reference is imported in a fixture, not at the top: the card's machine
runs this file's gpu tests without JAX."""
import bisect
import ctypes
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import dispatch
from repro_torch.kernels.optim import adamw
from repro_torch.kernels.optim.ref import adamw_update_ref, grad_sumsq_ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api, convert
from repro_torch.models.common import tensor_leaves
from repro_torch.serving import graphs
from repro_torch.train import optimizer
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.data import LMBatches
from repro_torch.train.loop import batch_on, train

OPT_TOL = 1e-6    # AdamW on the same leaves: elementwise rounding only
SUMSQ_TOL = 1e-6  # float32 sums of squares in another order
LOSS_TOL = 1e-5   # the whole model, float32: summation order only
STEP_TOL = 1e-4   # params after a few steps, relative L2 per leaf
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
# leaf sizes: ragged (not multiples of 8), one element, one empty, and some
# wider than a K4 or K5 tile
SIZES = [(8, 16), (3, 5), (1,), (0,), (7,), (70000,), (3, 4, 5), (33000,)]
# the edges of K5's tiles (UPDATE_TILE elements, walked 8 * THREADS at a
# time): tails of 1-7 elements after whole 8-vectors, a leaf shorter than
# one step of a block's threads, a tile and one more or less, an empty leaf
_T, _STEP = adamw.UPDATE_TILE, adamw.THREADS * 8
EDGES = [1, 2, 3, 4, 5, 6, 7, 9, 15, 17, _STEP - 1, _STEP, _STEP + 1, _T - 1, _T, _T + 1,
         2 * _T + 7, 300001, 0]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as ref_steps
    from repro.train import loop as ref_loop
    from repro.train import optimizer as ref_opt
    from repro.models import api as ref_api
    from repro.configs.registry import ARCHS
    return SimpleNamespace(jax=jax, jnp=jnp, opt=ref_opt, steps=ref_steps, loop=ref_loop,
                           api=ref_api, archs=ARCHS)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves(seed, sizes=SIZES, dtype=torch.float32, scale=1.0, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
            .to(device=device, dtype=dtype) for s in sizes]


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units of the last place between two finite
    bf16 tensors: bit patterns mapped to integers in the values' order."""
    def order(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((order(a) - order(b)).abs().max()) if a.numel() else 0


# ----------------------------------------------------------------------
# the plain versions against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_sumsq_plain_equals_the_reference_global_norm(ref, dtype):
    grads = _leaves(0, dtype=dtype, scale=0.3)
    want = ref.opt.global_norm([ref.jnp.asarray(g.float().numpy().copy()).astype(
        ref.jnp.bfloat16 if dtype == torch.bfloat16 else ref.jnp.float32) for g in grads])
    got = grad_sumsq_ref(grads)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _rel(torch.sqrt(got), want) < SUMSQ_TOL
    assert _rel(optimizer.global_norm(grads), want) < SUMSQ_TOL


@pytest.mark.parametrize("pdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_adamw_update_plain_equals_the_reference_update(ref, pdt, gdt):
    """Two steps of the plain version on the reference's scalars (clip
    scale, lr, b1c, b2c at steps 1 and 2), leaf for leaf against the
    reference's ``AdamW.update``: moments within 1e-6, float32 params within
    1e-6 and bf16 params within one ulp."""
    jnp = ref.jnp
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    params = _leaves(1, dtype=pdt)
    ref_opt = ref.opt.AdamW(learning_rate=1e-2, clip_norm=1.0)
    ref_params = [jnp.asarray(p.float().numpy().copy()).astype(jdt[pdt]) for p in params]
    ref_state = ref_opt.init(ref_params)
    mu = [torch.zeros(p.shape) for p in params]
    nu = [torch.zeros(p.shape) for p in params]
    for step in (1, 2):
        grads = _leaves(10 + step, dtype=gdt, scale=0.5)
        ref_grads = [jnp.asarray(g.float().numpy().copy()).astype(jdt[gdt]) for g in grads]
        ref_params, ref_state, rm = ref_opt.update(ref_params, ref_grads, ref_state)
        gnorm = float(rm["grad_norm"])
        scale = min(1.0, 1.0 / (gnorm + 1e-9))
        b1c, b2c = (float(1.0 - jnp.float32(b) ** jnp.float32(step)) for b in (0.9, 0.95))
        scalars = torch.tensor([scale, 1e-2, b1c, b2c], dtype=torch.float32)
        adamw_update_ref(params, grads, mu, nu, scalars, **HYPER)
        for a, b in zip(mu, ref_state["mu"]):
            assert _rel(a, b) < OPT_TOL
        for a, b in zip(nu, ref_state["nu"]):
            assert _rel(a, b) < OPT_TOL
        for a, b in zip(params, ref_params):
            assert a.dtype == pdt
            if pdt == torch.bfloat16:
                assert _ulps(a, torch.from_numpy(np.array(b.astype(jnp.float32)))
                             .to(torch.bfloat16)) <= 1
            else:
                assert _rel(a, b) < OPT_TOL


def test_device_step_schedule_and_update_match_the_reference(ref):
    """The step count is a 0-d int32 tensor that ``update`` advances in
    place; lr, grad_norm come back as tensors, step for step the
    reference's."""
    sched = optimizer.cosine_schedule(1e-2, warmup=2, total=6)
    ref_sched = ref.opt.cosine_schedule(1e-2, warmup=2, total=6)
    for step in range(8):
        got = sched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(ref_sched(ref.jnp.asarray(step)))) <= OPT_TOL * 1e-2
    opt = optimizer.AdamW(learning_rate=sched)
    params = _leaves(2, sizes=[(8, 16), (5,)])
    state = opt.init(params)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    step_tensor = state["step"]
    ref_opt = ref.opt.AdamW(learning_rate=ref_sched)
    ref_params = [ref.jnp.asarray(p.numpy().copy()) for p in params]
    ref_state = ref_opt.init(ref_params)
    for i in range(4):
        grads = _leaves(20 + i, sizes=[(8, 16), (5,)], scale=2.0)
        params, state, m = opt.update(params, grads, state)
        ref_params, ref_state, rm = ref_opt.update(
            ref_params, [ref.jnp.asarray(g.numpy().copy()) for g in grads], ref_state)
        assert state["step"] is step_tensor and int(state["step"]) == i + 1
        assert isinstance(m["lr"], torch.Tensor) and isinstance(m["grad_norm"], torch.Tensor)
        assert abs(float(m["lr"]) - float(rm["lr"])) <= OPT_TOL * abs(float(rm["lr"]))
        assert _rel(m["grad_norm"], rm["grad_norm"]) < OPT_TOL
        for a, b in zip(params, ref_params):
            assert _rel(a, b) < OPT_TOL


def test_a_constant_learning_rate_is_a_device_tensor():
    opt = optimizer.AdamW(learning_rate=3e-4)
    params = _leaves(3, sizes=[(4,)])
    _, _, m = opt.update(params, _leaves(4, sizes=[(4,)]), opt.init(params))
    assert m["lr"].dtype == torch.float32 and float(m["lr"]) == np.float32(3e-4)


def test_dispatch_takes_the_plain_versions_on_the_cpu_without_counting():
    grads = _leaves(5, dtype=torch.bfloat16)
    n4, n5 = adamw.SUMSQ.launches, adamw.UPDATE.launches
    assert torch.equal(dispatch.grad_sumsq(grads), grad_sumsq_ref(grads))
    params, twin = _leaves(6), _leaves(6)
    moments = [[torch.zeros(p.shape) for p in params] for _ in range(4)]
    scalars = torch.tensor([0.5, 1e-3, 0.1, 0.05])
    dispatch.adamw_update(params, grads, *moments[:2], scalars, **HYPER)
    adamw_update_ref(twin, grads, *moments[2:], scalars, **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(params, twin))
    assert (adamw.SUMSQ.launches, adamw.UPDATE.launches) == (n4, n5)


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA|cuda"):
        adamw.grad_sumsq(_leaves(7, sizes=[(4,)]))
    p = _leaves(8, sizes=[(4,)])
    with pytest.raises(ValueError, match="CUDA|cuda"):
        adamw.adamw_update(p, p, p, p, torch.zeros(4), **HYPER)


# ----------------------------------------------------------------------
# the leaf tables the kernels take by value
# ----------------------------------------------------------------------

def test_tables_fit_a_kernel_parameter_and_match_the_source_layout():
    """The ctypes tables are the source's structs: a pointer, an int64 size,
    two ints a leaf; K4's table with its count, first partial and blocks,
    K5's with its count and blocks; each launch's parameters under 4 KB."""
    assert ctypes.sizeof(adamw.SumsqLeaf) == 24 and ctypes.sizeof(adamw.UpdateLeaf) == 48
    assert ctypes.sizeof(adamw.SumsqTable) == 24 * adamw.SUMSQ_LEAVES + 16
    assert ctypes.sizeof(adamw.UpdateTable) == 48 * adamw.UPDATE_LEAVES + 8
    assert ctypes.sizeof(adamw.SumsqTable) + 8 <= 4096
    assert ctypes.sizeof(adamw.UpdateTable) + 8 + 6 * 4 <= 4096
    src = (adamw.build.CSRC / "adamw.cu").read_text()
    for name in ("SUMSQ_LEAVES", "UPDATE_LEAVES", "THREADS"):
        assert f"constexpr int {name} = {getattr(adamw, name)};" in src
    assert "constexpr int VEC = 8;" in src
    assert "constexpr int SUMSQ_TILE = THREADS * VEC * 8;" in src
    assert "constexpr int UPDATE_TILE = THREADS * VEC * 4;" in src
    assert (adamw.SUMSQ_TILE, adamw.UPDATE_TILE) == (adamw.THREADS * 8 * 8, adamw.THREADS * 8 * 4)


@pytest.mark.parametrize("n_leaves", [1, 64, 65, 129, 300])
def test_tables_cover_every_tile_of_every_non_empty_leaf_once(n_leaves):
    rng = np.random.default_rng(n_leaves)
    sizes = [int(rng.integers(0, 40000)) for _ in range(n_leaves)]
    leaves = [(torch.empty(n),) for n in sizes]
    for cls, per, tile in ((adamw.SumsqTable, adamw.SUMSQ_LEAVES, adamw.SUMSQ_TILE),
                           (adamw.UpdateTable, adamw.UPDATE_LEAVES, adamw.UPDATE_TILE)):
        tables, total = adamw._tables(cls, per, tile, leaves, lambda e, leaf: None)
        live = [n for n in sizes if n]
        assert len(tables) == -(-len(live) // per)
        seen, base = [], 0
        for t in tables:
            assert 1 <= t.count <= per
            blocks = 0
            for j in range(t.count):
                e = t.leaf[j]
                assert e.first == blocks and e.n > 0
                blocks += -(-e.n // tile)
                seen.append(e.n)
            assert t.blocks == blocks
            if cls is adamw.SumsqTable:
                assert t.base == base
            base += blocks
        assert seen == live and total == base == sum(-(-n // tile) for n in live)


@pytest.mark.parametrize("case", ["edges", "ragged", "many"])
def test_update_launch_covers_every_element_of_every_leaf_once(case):
    """K5's index arithmetic replayed on the wrapper's launch plan (its
    tables: each launch ``blocks`` blocks, each leaf's ``first`` block and
    ``n``): block b takes tile b - first of the last leaf whose first <= b;
    its thread t the 8-vectors at start + 8 t + 8 THREADS k below the tile's
    last whole vector (each loaded one step ahead, so the same addresses),
    then the tail elements after it one by one.  Every element of every
    non-empty leaf is updated exactly once, nothing outside a leaf, and no
    vector crosses its tile's end."""
    rng = np.random.default_rng(7)
    sizes = {"edges": EDGES, "ragged": [int(np.prod(s)) for s in SIZES],
             "many": [int(n) for n in rng.integers(0, 3 * _T, 150)] + [0, 1, 7]}[case]
    leaves = [tuple(torch.empty(n) for _ in range(4)) for n in sizes]
    tables, total = adamw._tables(adamw.UpdateTable, adamw.UPDATE_LEAVES, adamw.UPDATE_TILE,
                                  leaves, lambda e, leaf: None)
    counts = []
    t_idx = np.arange(adamw.THREADS)
    for t in tables:
        firsts = [t.leaf[j].first for j in range(t.count)]
        cover = [np.zeros(t.leaf[j].n, np.int64) for j in range(t.count)]
        for b in range(t.blocks):
            j = bisect.bisect_right(firsts, b) - 1
            e, got = t.leaf[j], cover[j]
            start = (b - e.first) * _T
            end = min(start + _T, e.n)
            assert 0 <= start < end
            vend = start + (end - start) // 8 * 8
            for i in range(start, vend, _STEP):
                first = i + 8 * t_idx[i + 8 * t_idx < vend]
                assert (first + 8 <= end).all()
                np.add.at(got, (first[:, None] + np.arange(8)).ravel(), 1)
            assert end - vend < 8
            got[vend:end] += 1
        counts += cover
    assert total == sum(t.blocks for t in tables)
    assert [c.size for c in counts] == [n for n in sizes if n]
    assert all((c == 1).all() for c in counts)


# ----------------------------------------------------------------------
# train() through the TrainGraph
# ----------------------------------------------------------------------

def _run(cfg, dev, *, num_micro=1, steps=3, captured=True, params=None, batch=4, seq=16):
    """``steps`` AdamW steps of seeded weights (or ``params``) on
    ``LMBatches`` seed 0: through one ``TrainGraph`` (``captured``) or
    ``make_train_step`` called directly.  -> (losses, params as CPU
    tensors, the graph or None)."""
    if params is None:
        params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = optimizer.AdamW(learning_rate=optimizer.cosine_schedule(1e-2, warmup=1,
                                                                  total=steps))
    state = opt.init(params)
    fn = make_train_step(cfg, opt, num_micro=num_micro)
    data = LMBatches(cfg.vocab_size, batch, seq, seed=0)
    losses, graph = [], None
    for i in range(steps):
        b = batch_on(data(i), cfg, dev)
        if captured:
            graph = graph or graphs.TrainGraph(fn, params, state, b, dev)
            m = graph.run(b)
        else:
            m = fn(params, state, b)[2]
        losses.append(float(m["loss"]))
    return losses, [p.detach().cpu() for p in tensor_leaves(params)], graph


@pytest.mark.parametrize("arch,num_micro", [("deepseek-7b", 1), ("deepseek-7b", 2),
                                            ("granite-moe-3b-a800m", 2), ("rwkv6-1.6b", 1)])
def test_train_graph_equals_the_direct_step_bit_for_bit_on_the_cpu(arch, num_micro):
    cfg = registry.get(arch).smoke
    want_losses, want, _ = _run(cfg, "cpu", num_micro=num_micro, captured=False)
    losses, got, graph = _run(cfg, "cpu", num_micro=num_micro)
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not graph.captured and graph.replays == 3
    assert {"grad_norm", "lr", "loss"} <= set(graph.metrics)


@pytest.mark.parametrize("num_micro", [1, 2])
def test_train_through_the_graph_equals_the_direct_step_and_the_reference(ref, tmp_path,
                                                                          num_micro):
    """``train()`` (a ``TrainGraph``, eager on the CPU) from the reference's
    init: its losses equal ``make_train_step`` called directly bit for bit,
    and the reference's jitted ``train`` within the float32 bars; its final
    checkpoint's params equal the direct steps' bit for bit and the
    reference's within ``STEP_TOL``."""
    arch = "deepseek-7b"
    cfg, ref_cfg = registry.get(arch).smoke, ref.archs[arch].smoke
    tree = ref.jax.tree_util.tree_map(np.array,
                                      ref.api.init_params(ref.jax.random.PRNGKey(0), ref_cfg))
    kw = dict(steps=4, batch=4, seq=16, lr=1e-2, seed=0, num_micro=num_micro, verbose=False)
    with mock.patch("repro_torch.train.loop.api.init_params",
                    lambda *a, **k: convert.from_reference(tree, cfg, "cpu")):
        rep = train(cfg, ckpt_path=str(tmp_path / "port"), device="cpu", **kw)
    want = ref.loop.train(ref_cfg, ckpt_path=str(tmp_path / "ref"), **kw)
    params = convert.from_reference(tree, cfg, "cpu")
    opt = optimizer.AdamW(learning_rate=optimizer.cosine_schedule(1e-2, warmup=1, total=4))
    state = opt.init(params)
    fn = make_train_step(cfg, opt, num_micro=num_micro)
    data = LMBatches(cfg.vocab_size, 4, 16, seed=0)
    direct = [float(fn(params, state, batch_on(data(i), cfg, "cpu"))[2]["loss"])
              for i in range(4)]
    assert rep.losses == direct
    for a, b in zip(rep.losses, want.losses):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    port, ref_ckpt = (np.load(str(tmp_path / f"{n}.npz")) for n in ("port", "ref"))
    flat = [t.detach().numpy() for t in _flatten(convert.to_reference(params, cfg))]
    assert sorted(port.files) == sorted(ref_ckpt.files) and len(port.files) == len(flat)
    for i, leaf in enumerate(flat):
        np.testing.assert_array_equal(port[f"a{i}"], leaf)
        assert _rel(port[f"a{i}"], ref_ckpt[f"a{i}"]) < STEP_TOL


# ----------------------------------------------------------------------
# on the card: K4 and K5 against their plain versions, and the replayed
# train step against the uncaptured one
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _uncaptured():
    return mock.patch.object(graphs.CapturedStep, "capture", lambda self: None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_leaves", [len(SIZES), 300])
def test_grad_sumsq_kernel_matches_plain(cuda, dtype, n_leaves):
    sizes = (SIZES * (n_leaves // len(SIZES) + 1))[:n_leaves]
    grads = _leaves(30, sizes=sizes, dtype=dtype, scale=0.3, device=cuda)
    n = adamw.SUMSQ.launches
    got = adamw.grad_sumsq(grads)
    again = adamw.grad_sumsq(grads)
    torch.cuda.synchronize()
    assert adamw.SUMSQ.launches == n + 2
    assert _rel(got.cpu(), grad_sumsq_ref([g.cpu() for g in grads])) < SUMSQ_TOL
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("pdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("n_leaves", [len(SIZES), 150, "edges", "zeros"])
def test_adamw_update_kernel_matches_plain(cuda, pdt, gdt, n_leaves):
    """K5 against the plain update bit for bit (every operation rounded on
    its own on both sides), over ragged leaves, more than one table of
    them, the edges of its tiles, and zero gradients and moments (K5's
    shortcut past the divisions); two runs bit for bit the same."""
    sizes = ([(n,) for n in EDGES] if n_leaves == "edges"
             else SIZES if n_leaves == "zeros"
             else (SIZES * (n_leaves // len(SIZES) + 1))[:n_leaves])
    scalars = torch.tensor([0.7, 1e-2, 0.19, 0.0975], device=cuda)
    runs = []
    for fn in (adamw.adamw_update, adamw.adamw_update, adamw_update_ref):
        params = _leaves(40, sizes=sizes, dtype=pdt, device=cuda)
        grads = _leaves(41, sizes=sizes, dtype=gdt, device=cuda)
        mu = _leaves(42, sizes=sizes, scale=0.1, device=cuda)
        nu = [m.square() for m in _leaves(43, sizes=sizes, scale=0.1, device=cuda)]
        if n_leaves == "zeros":        # the first half of each leaf zero, mu -0 in a quarter
            for g, m, v in zip(grads, mu, nu):
                for t in (g, m, v):
                    t.view(-1)[:t.numel() // 2] = 0
                m.view(-1)[:m.numel() // 4] = -0.0
        fn(params, grads, mu, nu, scalars, **HYPER)
        runs.append((params, mu, nu))
    torch.cuda.synchronize()
    (p1, m1, n1), (p2, m2, n2), (pw, mw, nw) = runs
    assert all(torch.equal(a, b) for a, b in zip(p1 + m1 + n1, p2 + m2 + n2))
    assert all(torch.equal(a, b) for a, b in zip(p1 + m1 + n1, pw + mw + nw))
    for a, b in zip(m1 + n1, mw + nw):
        assert _rel(a.cpu(), b.cpu()) < OPT_TOL
    for a, b in zip(p1, pw):
        if pdt == torch.bfloat16:
            assert _ulps(a.cpu(), b.cpu()) <= 1
        else:
            assert _rel(a.cpu(), b.cpu()) < OPT_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("arch,num_micro,dtype", [
    ("deepseek-7b", 1, "bfloat16"), ("deepseek-7b", 2, "float32"),
    ("granite-moe-3b-a800m", 1, "bfloat16"), ("rwkv6-1.6b", 1, "float32"),
    ("rwkv6-1.6b", 2, "bfloat16")])
def test_replayed_train_step_equals_the_uncaptured_step(cuda, arch, num_micro, dtype):
    """Three steps through a captured ``TrainGraph`` (the warm-up, then two
    replays) against three uncaptured steps from the same seed: losses and
    params bit for bit; K4 and K5 once a step, K1-bwd or K3-bwd once a layer
    a microbatch, replays included."""
    from repro_torch.kernels.attention import flash_bwd
    from repro_torch.kernels.rwkv import wkv_bwd

    cfg = registry.get(arch).smoke.replace(param_dtype=dtype, compute_dtype=dtype)
    with _uncaptured():
        want_losses, want, _ = _run(cfg, cuda, num_micro=num_micro, seq=64)
    bwd = wkv_bwd if cfg.family == "ssm" else flash_bwd
    n = (adamw.SUMSQ.launches, adamw.UPDATE.launches, bwd.launches)
    losses, got, graph = _run(cfg, cuda, num_micro=num_micro, seq=64)
    torch.cuda.synchronize()
    assert graph.captured and graph.replays == 2
    assert losses == want_losses and all(np.isfinite(losses))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (adamw.SUMSQ.launches - n[0], adamw.UPDATE.launches - n[1]) == (3, 3)
    assert bwd.launches - n[2] == 3 * num_micro * cfg.num_layers
