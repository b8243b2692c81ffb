"""The port's captured prefills and CNN forward (``repro_torch.serving.graphs``
``PrefillGraph`` and ``ForwardGraph``): the engine's prefill, the continuous
server's admission and the calibration's forward, fed through their static
buffers, against the live reference on the CPU (where the same step runs
eagerly); their launch accounting; and, on a card (``pytest -m gpu``),
replayed logits, tokens and forwards against uncaptured ones on the smoke
configs.

The reference is imported inside fixtures: the card's machine runs this
file's gpu tests without JAX."""
import contextlib
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_7b, registry, rwkv6_1p6b
from repro_torch.core import calibration
from repro_torch.kernels.attention import flash
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.rwkv import wkv
from repro_torch.models import cnn
from repro_torch.models.convert import from_reference
from repro_torch.serving import graphs
from repro_torch.serving.continuous import ContinuousServer, Request
from repro_torch.serving.engine import InferenceEngine, bucket_len

CFGS = {"dense": deepseek_7b.SMOKE, "ssm": rwkv6_1p6b.SMOKE}
TOL = 1e-5            # float32 smoke configs, the same algorithm; sums in another order
CNN_REL_TOL = 1e-5    # tests/test_torch_cnn.py's bar against the reference
MAX_CACHE = 96


@pytest.fixture(scope="module")
def ref():
    """The reference's registry, engine, continuous server and CNNs, on
    JAX's CPU backend."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import ARCHS, PAPER_MODELS
    from repro.models import api as ref_api
    from repro.models import cnn as ref_cnn
    from repro.serving import continuous, engine
    return SimpleNamespace(jax=jax, jnp=jnp, api=ref_api, engine=engine,
                           continuous=continuous, cnn=ref_cnn, paper=PAPER_MODELS,
                           cfgs={"dense": ARCHS["deepseek-7b"].smoke,
                                 "ssm": ARCHS["rwkv6-1.6b"].smoke})


def _ref_tree(ref, family, seed=0):
    """The reference's init as numpy; for RWKV-6 each layer's ``tmix.wo.w``
    and ``tmix.decay_w2`` are redrawn non-zero, so the WKV branch (the
    reference draws ``wo`` as 0) reaches the logits."""
    cfg = ref.cfgs[family]
    tree = ref.jax.tree_util.tree_map(
        np.array, ref.api.init_params(ref.jax.random.PRNGKey(seed), cfg))
    if family == "ssm":
        rng = np.random.default_rng(seed + 100)
        tmix = tree["layers"]["tmix"]
        for leaf, key in ((tmix["wo"], "w"), (tmix, "decay_w2")):
            a = leaf[key]
            leaf[key] = (rng.standard_normal(a.shape) / np.sqrt(cfg.d_model)).astype(a.dtype)
    return tree


def _engines(ref, family):
    """(reference engine, port engine) on the same weights, both fresh."""
    tree = _ref_tree(ref, family)
    r = ref.engine.InferenceEngine(ref.cfgs[family], seed=0, max_cache=MAX_CACHE)
    r.params = ref.jax.tree_util.tree_map(ref.jnp.asarray, tree)
    return r, InferenceEngine(CFGS[family], max_cache=MAX_CACHE,
                              params=from_reference(tree, CFGS[family], "cpu"),
                              device="cpu")


@pytest.fixture(scope="module")
def engines(ref):
    return {family: _engines(ref, family) for family in CFGS}


def _prompt(batch, length, seed):
    return np.random.default_rng(seed).integers(0, 512, size=(batch, length))


def _ref_prefill_logits(ref, ref_eng, family, prompt, n_new):
    """The reference engine's jitted prefill of ``prompt`` as ``generate``
    pads it: -> the last logits, as numpy."""
    s = prompt.shape[1]
    s_pad, cache_len = ref_eng._prefill_shapes(s, n_new)
    tokens = np.pad(prompt, ((0, 0), (0, s_pad - s))).astype(np.int32)
    last = ref.jnp.int32(s - 1) if s_pad > s else None
    logits, _ = ref_eng._prefill(ref_eng.params, {"tokens": ref.jnp.asarray(tokens)},
                                 cache_len=cache_len, last_pos=last)
    return np.asarray(logits)


def _port_prefill_logits(eng, prompt, n_new):
    """The port engine's prefill through its graph's buffers, as
    ``generate`` runs it."""
    tokens, last_pos, cache_len = eng._prompt(prompt, n_new)
    logits, _ = eng._prefill(tokens, last_pos, cache_len)
    assert logits is eng._prefills[tuple(tokens.shape)].logits   # the static output
    return logits.cpu().numpy().copy()


# ----------------------------------------------------------------------
# the engine's prefill, through its graph's buffers, against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("lengths", [
    (5, 7, 8),          # one bucket of 8: padded, padded, exact
    (3, 12, 17, 16),    # buckets 4, 16, 32, then 16 again
])
def test_dense_engine_prefill_through_the_buffers_equals_reference(engines, ref, batch,
                                                                   lengths):
    ref_eng, eng = engines["dense"]
    for i, s in enumerate(lengths):
        prompt = _prompt(batch, s, seed=10 * s + batch)
        want = _ref_prefill_logits(ref, ref_eng, "dense", prompt, 5)
        np.testing.assert_allclose(_port_prefill_logits(eng, prompt, 5), want,
                                   atol=TOL, rtol=TOL)
        want = np.asarray(ref_eng.generate(ref.jnp.asarray(prompt, ref.jnp.int32), 5).tokens)
        np.testing.assert_array_equal(eng.generate(prompt, 5).tokens.numpy(), want)
    # one prefill (and its buffers) per (batch, bucket), reused across lengths
    assert {(batch, bucket_len(s)) for s in lengths} <= set(eng._prefills)
    assert eng.compile_stats()["prefill_graphs"] == 0           # no graph on the CPU


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_rwkv_engine_prefill_at_exact_lengths_equals_reference(engines, ref, batch):
    ref_eng, eng = engines["ssm"]
    for s in (3, 7, 12, 7):
        prompt = _prompt(batch, s, seed=20 * s + batch)
        want = _ref_prefill_logits(ref, ref_eng, "ssm", prompt, 6)
        np.testing.assert_allclose(_port_prefill_logits(eng, prompt, 6), want,
                                   atol=TOL, rtol=TOL)
        want = np.asarray(ref_eng.generate(ref.jnp.asarray(prompt, ref.jnp.int32), 6).tokens)
        np.testing.assert_array_equal(eng.generate(prompt, 6).tokens.numpy(), want)
    assert {(batch, s) for s in (3, 7, 12)} <= set(eng._prefills)


@pytest.mark.parametrize("family", sorted(CFGS))
def test_prefill_shapes_count_the_references_jit_keys(ref, family):
    """``compile_stats()["prefill"]`` counts what the reference's prefill jit
    caches, warm-up included; the prefill buffers are one per (batch,
    padded or exact length), dropped with the cache when the batch
    changes."""
    ref_eng, eng = _engines(ref, family)
    calls = [(1, 5), (1, 7), (1, 8), (2, 6), (2, 12), (1, 3)]
    for e in (ref_eng, eng):
        e.warmup(2, 10)
    for b, s in calls:
        prompt = _prompt(b, s, seed=s)
        ref_eng.generate(ref.jnp.asarray(prompt, ref.jnp.int32), 4)
        eng.generate(prompt, 4)
    assert eng.compile_stats()["prefill"] == ref_eng.compile_stats()["prefill"]
    assert eng.compile_stats()["prefill_graphs"] == 0
    b, s = calls[-1]
    key = (b, bucket_len(s) if family == "dense" else s)
    assert set(eng._prefills) == {key}                 # batch 1 again: the rest dropped


def test_engine_takes_the_decode_step_before_the_prefill(monkeypatch):
    """The prefill's replay resets the cache that the decode step's capture
    writes, so every engine path takes the step first."""
    order = []
    eng = InferenceEngine(CFGS["ssm"], seed=1, max_cache=32, device="cpu")
    decoder, prefiller = eng._decoder, eng._prefiller
    monkeypatch.setattr(eng, "_decoder", lambda *a: order.append("decode") or decoder(*a))
    monkeypatch.setattr(eng, "_prefiller", lambda *a: order.append("prefill") or prefiller(*a))
    eng.warmup(2, 5)
    eng.generate([[1, 2, 3]], 4)
    eng.generate_stream([[1, 2, 3]], 4, temperature=0.7)
    assert order == ["decode", "prefill"] * 3


# ----------------------------------------------------------------------
# the continuous server's admission
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_req,slots,max_seq,seed", [
    (9, 3, 64, 1),      # buckets 4 to 64, slots freed and refilled
    (6, 4, 48, 2),      # bucket capped at max_seq
])
def test_server_admission_through_the_buffers_equals_reference(ref, n_req, slots, max_seq,
                                                               seed):
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(2, 41))).tolist(),
             int(rng.integers(1, 9))) for i in range(n_req)]
    r = ref.continuous.ContinuousServer(ref.cfgs["dense"], slots=slots, max_seq=max_seq,
                                        seed=0)
    params = from_reference(ref.jax.tree_util.tree_map(np.asarray, r.params),
                            CFGS["dense"], "cpu")
    srv = ContinuousServer(CFGS["dense"], slots=slots, max_seq=max_seq, params=params,
                           device="cpu")
    done = []
    for server, cls in ((r, ref.continuous.Request), (srv, Request)):
        for rid, prompt, n in reqs:
            server.submit(cls(rid=rid, prompt=list(prompt), n_new=n))
        done.append([(c.rid, c.tokens, c.steps_in_flight) for c in server.run()])
    assert done[1] == done[0]
    stats, want = srv.compile_stats(), r.compile_stats()
    assert stats["prefill"] == want["prefill"] and stats["scatter"] == want["scatter"]
    buckets = {min(bucket_len(len(p)), max_seq) for _, p, _ in reqs}
    assert set(srv._admissions) <= buckets and len(srv._admissions) == stats["prefill"] > 1
    assert stats["prefill_graphs"] == 0


def test_admission_writes_into_the_admitted_slots_only():
    """A round of one request runs the prefill at the full slot count; only
    the admitted slot's cache changes, not the live slots' nor the free
    one's."""
    srv = ContinuousServer(CFGS["dense"], slots=4, max_seq=32, seed=0, device="cpu")
    for i, prompt in enumerate(([1, 2, 3, 4, 5], [6, 7, 8])):
        srv.submit(Request(rid=i, prompt=prompt, n_new=6))
    srv.prefill_pending()
    assert srv.active.tolist() == [True, True, False, False]
    for name in ("k", "v"):
        srv.cache[name][:, 3] = 7.0                       # the free slot, marked
    before = {n: t.clone() for n, t in srv.cache.items()}
    srv.submit(Request(rid=2, prompt=[9, 10, 11, 12, 13, 14, 15, 16, 17], n_new=4))
    srv.prefill_pending()
    assert srv.active.tolist() == [True, True, True, False]
    for name, t in srv.cache.items():
        for s in (0, 1, 3):
            assert torch.equal(t[:, s], before[name][:, s])
        # the bucket of 16 (the pad tokens' keys too, as the reference's
        # scatter writes them), zeros past it
        assert t[:, 2, :16].abs().sum() > 0 and not t[:, 2, 16:].any()
    assert srv._slots_dev[0].item() == 2


def test_admission_graphs_share_one_staging_buffer():
    srv = ContinuousServer(CFGS["dense"], slots=2, max_seq=32, seed=0, device="cpu")
    for i, n in enumerate((3, 9, 20)):
        srv.submit(Request(rid=i, prompt=list(range(1, n + 1)), n_new=1))
        srv.run()
    assert sorted(srv._admissions) == [4, 16, 32]
    base = srv._staging["k"].data_ptr()
    for bucket, (graph, cache) in srv._admissions.items():
        assert cache["k"].data_ptr() == base and cache["k"].shape[2] == bucket
        assert graph.tokens.shape == (2, bucket) and graph.pool is None   # no pool on the CPU


# ----------------------------------------------------------------------
# the buffers and the launch accounting
# ----------------------------------------------------------------------

class StubGraph:
    """Stands in for a CUDA graph on the CPU."""
    replays = 0

    def replay(self):
        self.replays += 1


def test_prefill_replay_adds_the_captured_launches():
    """A two-layer dense prefill ticks K1 twice under capture; each replay
    adds two, and the capture itself adds none."""
    calls = []

    def prefill(tokens, last):
        calls.append(last.tolist())
        flash.launches += 2
        return torch.ones((tokens.shape[0], 8))

    graph = graphs.PrefillGraph(2, 4, 8, torch.float32, torch.device("cpu"), prefill)
    before = {m: m.launches for m in (flash, fd, wkv)}
    stub = StubGraph()
    graph.record(stub, contextlib.nullcontext())
    assert graph.captured and calls == [[3, 3]]
    assert {m: m.launches for m in (flash, fd, wkv)} == before
    assert graph.added == {**dict.fromkeys(graphs.COUNTED, 0), flash: 2}
    for last in (None, 1, torch.tensor([0, 2])):
        graph.run(torch.zeros((2, 4), dtype=torch.long), last)
    assert stub.replays == 3 == graph.replays and len(calls) == 1
    assert flash.launches == before[flash] + 6 and graph.last.tolist() == [0, 2]


@pytest.mark.parametrize("last,want", [(None, [5, 5]), (2, [2, 2]),
                                       (torch.tensor([1, 4]), [1, 4])])
def test_prefill_run_copies_into_its_buffers(last, want):
    seen = []
    graph = graphs.PrefillGraph(2, 6, 3, torch.float32, "cpu",
                                lambda t, l: seen.append((t.clone(), l.clone()))
                                or t[:, :3].float() + l[:, None])
    tokens, logits = graph.tokens, graph.logits
    out = graph.run(torch.arange(12).reshape(2, 6), last)
    assert out is logits and graph.tokens is tokens and graph.last.tolist() == want
    assert torch.equal(seen[0][0], torch.arange(12).reshape(2, 6))
    assert torch.equal(out, torch.arange(12).reshape(2, 6)[:, :3].float()
                       + torch.tensor(want)[:, None])


def test_capture_of_a_prefill_is_a_no_op_on_the_cpu():
    graph = graphs.PrefillGraph(1, 4, 8, torch.float32, "cpu", lambda t, l: None)
    graph.capture()
    assert not graph.captured and graph.added == {} and graph.replays == 0


# ----------------------------------------------------------------------
# the CNN forward through its buffer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["squeezenet", "resnet18", "resnext50"])
def test_forward_through_its_buffer_equals_cnn_forward_and_the_reference(ref, name):
    cfg = registry.get(name).smoke
    rng = np.random.default_rng(5)
    tree = ref.jax.tree_util.tree_map(
        np.array, ref.cnn.init_params(ref.jax.random.PRNGKey(0), ref.paper[name].smoke))
    _redraw_bn(tree, rng)
    params = from_reference(tree, cfg, "cpu")
    x = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    images = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    graph = graphs.ForwardGraph(images.shape, cfg.num_classes, "cpu",
                                lambda im: cnn.forward(params, im, cfg))
    graph.capture()
    got = graph.run(images)
    assert got is graph.logits and not graph.captured
    assert torch.equal(got, cnn.forward(params, images, cfg))
    want = np.asarray(ref.cnn.forward(ref.jax.tree_util.tree_map(ref.jnp.asarray, tree),
                                      ref.jnp.asarray(x), ref.paper[name].smoke))
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < CNN_REL_TOL


def _redraw_bn(tree, rng):
    """Redraw every folded BatchNorm's scale (U(0.5, 1.5)) and bias
    (N(0, 0.1)) in place: the init's 1 and 0 would hide a BatchNorm dropped
    or broadcast on the wrong axis."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for _, v in items:
        if isinstance(v, dict) and set(v) == {"scale", "bias"}:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = rng.normal(0.0, 0.1, v["bias"].shape).astype(np.float32)
        elif isinstance(v, (dict, list)):
            _redraw_bn(v, rng)


def test_calibration_times_the_forward_through_its_graph(monkeypatch):
    """The CNN entry's first call and every warm call go through one
    ForwardGraph at batch 1."""
    made = []
    real = graphs.ForwardGraph

    def spy(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    monkeypatch.setattr(calibration, "ForwardGraph", spy)
    entry = calibration.measure_model("squeezenet", smoke=True, device="cpu", repeats=3)
    assert set(entry) == {"kind", "warm_exec_s", "first_call_s"}
    assert len(made) == 1 and made[0].replays == 1 + 3
    assert made[0].images.shape == (1, 3, 64, 64)


# ----------------------------------------------------------------------
# on the card: replayed prefills and forwards against uncaptured ones
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _uncaptured():
    """New decode steps, prefills and forwards stay uncaptured."""
    return mock.patch.object(graphs.CapturedStep, "capture", lambda self: None)


def _card_engine(family, cuda, params=None):
    eng = InferenceEngine(CFGS[family], seed=0, max_cache=MAX_CACHE, params=params,
                          device=cuda)
    if family == "ssm" and params is None:
        gen = torch.Generator(device=cuda).manual_seed(1)
        d = CFGS[family].d_model
        for lp in eng.params["layers"]:
            lp["tmix"]["wo"]["w"] = torch.randn((d, d), generator=gen, device=cuda) * d ** -0.5
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(CFGS))
def test_replayed_prefill_equals_the_uncaptured_one(cuda, family):
    eng = _card_engine(family, cuda)
    with _uncaptured():
        plain = _card_engine(family, cuda, params=eng.params)
    kernel = wkv if family == "ssm" else flash
    layers = CFGS[family].num_layers
    for batch, s in ((1, 11), (3, 11), (3, 27), (3, 11)):
        prompt = np.random.default_rng(s + batch).integers(0, 512, size=(batch, s))
        with _uncaptured():
            want = _port_prefill_logits(plain, prompt, 8)
            want_tokens = plain.generate(prompt, 8).tokens
        n = kernel.launches
        got = _port_prefill_logits(eng, prompt, 8)
        torch.cuda.synchronize()
        key = (batch, bucket_len(s) if family == "dense" else s)
        graph = eng._prefills[key]
        assert graph.captured
        # a new graph's warm-up and its first replay, or one replay
        assert kernel.launches - n == layers * (1 + (graph.replays == 1))
        np.testing.assert_array_equal(got, want)
        assert torch.equal(eng.generate(prompt, 8).tokens, want_tokens)
    assert plain.compile_stats()["prefill_graphs"] == 0
    assert eng.compile_stats()["prefill_graphs"] == 3


@pytest.mark.gpu
def test_replayed_admission_equals_the_uncaptured_one(cuda):
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(4, 60))).tolist(),
             int(rng.integers(3, 30))) for i in range(10)]
    srv = ContinuousServer(CFGS["dense"], slots=4, max_seq=128, seed=0, device=cuda)
    with _uncaptured():
        plain = ContinuousServer(CFGS["dense"], slots=4, max_seq=128, params=srv.params,
                                 device=cuda)

    def serve(server):
        for rid, prompt, n in reqs:
            server.submit(Request(rid=rid, prompt=prompt, n_new=n))
        return [(c.rid, c.tokens) for c in server.run()]

    with _uncaptured():
        want = serve(plain)
    assert serve(srv) == want
    assert srv.compile_stats()["prefill_graphs"] == len(srv._admissions) > 1
    assert plain.compile_stats()["prefill_graphs"] == 0
    n = flash.launches
    replays = sum(g.replays for g, _ in srv._admissions.values())
    assert serve(srv) == want             # the same graphs, a second drain
    again = sum(g.replays for g, _ in srv._admissions.values()) - replays
    assert flash.launches - n == CFGS["dense"].num_layers * again


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["squeezenet", "resnet18", "resnext50"])
@pytest.mark.parametrize("batch", [1, 4])
def test_replayed_forward_equals_the_uncaptured_one(cuda, name, batch):
    cfg = registry.get(name).smoke
    params = cnn.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    images = torch.randn((batch, 3, cfg.image_size, cfg.image_size),
                         generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    graph = graphs.ForwardGraph(images.shape, cfg.num_classes, cuda,
                                lambda im: cnn.forward(params, im, cfg))
    graph.capture()
    got = graph.run(images).clone()
    want = cnn.forward(params, images, cfg)
    torch.cuda.synchronize()
    assert graph.captured
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < 1e-4, rel           # chip_smoke.py's CNN_REL_TOL: cuDNN may pick other algorithms
    flipped = images.flip(0).contiguous()
    got = graph.run(flipped)
    want = cnn.forward(params, flipped, cfg)
    assert ((got - want).norm() / want.norm()).item() < 1e-4
