"""The port's captured decode step (``repro_torch.serving.graphs``): the engine
and the continuous server, fed device positions through the step's static
buffers, against the live reference on the CPU; the step's buffers and its
launch accounting; and, on a card (``pytest -m gpu``), replayed tokens against
the uncaptured step's on the smoke configs.

The reference is imported inside fixtures: the card's machine runs this
file's gpu tests without JAX."""
import contextlib
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import (deepseek_7b, llava_next_mistral_7b, recurrentgemma_9b,
                                 rwkv6_1p6b, whisper_tiny)
from repro_torch.kernels.attention import flash
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.rwkv import wkv
from repro_torch.models import transformer
from repro_torch.models.convert import from_reference
from repro_torch.serving import graphs
from repro_torch.serving.continuous import ContinuousServer, Request
from repro_torch.serving.engine import InferenceEngine

CFGS = {"dense": deepseek_7b.SMOKE, "ssm": rwkv6_1p6b.SMOKE}


@pytest.fixture(scope="module")
def ref():
    """The reference's registry, engine and continuous server, on JAX's CPU
    backend."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import ARCHS
    from repro.models import api as ref_api
    from repro.serving import continuous, engine
    return SimpleNamespace(jax=jax, jnp=jnp, api=ref_api, engine=engine,
                           continuous=continuous,
                           cfgs={"dense": ARCHS["deepseek-7b"].smoke,
                                 "ssm": ARCHS["rwkv6-1.6b"].smoke})


def _ref_tree(ref, family, seed=0):
    """The reference's init as numpy; for RWKV-6 each layer's ``tmix.wo.w``
    and ``tmix.decay_w2`` are redrawn non-zero, so the WKV branch (the
    reference draws ``wo`` as 0) reaches the tokens."""
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


@pytest.fixture(scope="module")
def engines(ref):
    """family -> (reference engine, port engine) on the same weights."""
    out = {}
    for family, cfg in CFGS.items():
        tree = _ref_tree(ref, family)
        r = ref.engine.InferenceEngine(ref.cfgs[family], seed=0, max_cache=96)
        r.params = ref.jax.tree_util.tree_map(ref.jnp.asarray, tree)
        out[family] = (r, InferenceEngine(cfg, max_cache=96,
                                          params=from_reference(tree, cfg, "cpu"),
                                          device="cpu"))
    return out


# ----------------------------------------------------------------------
# the engine and the server, through the step's static buffers, against
# the live reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(CFGS))
@pytest.mark.parametrize("prompt,n_new", [
    ([[3, 1, 4, 1, 5, 9, 2, 6]], 7),
    ([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]], 70),   # past one token block of 64 steps
])
def test_engine_tokens_through_the_step_equal_reference(engines, family, prompt, n_new):
    ref_eng, eng = engines[family]
    want = np.asarray(ref_eng.generate(np.asarray(prompt, np.int32), n_new).tokens)
    got = eng.generate(np.asarray(prompt), n_new)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    stream = eng.generate_stream(np.asarray(prompt), n_new)
    np.testing.assert_array_equal(stream.tokens.numpy(), want)
    assert eng.compile_stats()["graphs"] == 0          # no graph on the CPU


@pytest.mark.parametrize("family", sorted(CFGS))
def test_sampled_engine_through_the_step_is_seeded(engines, family):
    """The sampled step draws from the engine's one generator, reseeded per
    request: a seed gives its tokens again, the stream gives generate's,
    and another seed gives others."""
    _, eng = engines[family]
    prompt = np.asarray([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]])
    a = eng.generate(prompt, 70, temperature=0.9, seed=5).tokens
    assert torch.equal(a, eng.generate(prompt, 70, temperature=0.9, seed=5).tokens)
    assert torch.equal(a, eng.generate_stream(prompt, 70, temperature=0.9, seed=5).tokens)
    assert not torch.equal(a, eng.generate(prompt, 70, temperature=0.9, seed=6).tokens)


@pytest.mark.parametrize("n_req,slots,max_seq,n_new", [
    (7, 3, 48, 5),
    (5, 2, 128, 70),     # chunks of 64 steps, the token block's length
])
def test_continuous_server_through_the_step_equals_reference(ref, n_req, slots, max_seq,
                                                             n_new):
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(4, 12))).tolist(), n_new)
            for i in range(n_req)]
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
    assert srv.steps == r.steps and srv.compile_stats()["graphs"] == 0


# ----------------------------------------------------------------------
# the step's buffers
# ----------------------------------------------------------------------

def test_engine_hands_attention_decode_device_positions_only(monkeypatch):
    """A replayed step would keep writing at a captured host int: every
    decode the engine runs (warmup, generate, generate_stream, greedy and
    sampled) gets a (B,) tensor of positions."""
    seen = []
    real = transformer.attention_decode

    def spy(p, x, pos, *args, **kw):
        seen.append(pos)
        return real(p, x, pos, *args, **kw)

    monkeypatch.setattr(transformer, "attention_decode", spy)
    eng = InferenceEngine(CFGS["dense"], seed=1, max_cache=32, device="cpu")
    eng.warmup(2, 5)
    for temp in (0.0, 0.8):
        eng.generate([[1, 2, 3], [4, 5, 6]], 4, temperature=temp)
        eng.generate_stream([[1, 2, 3], [4, 5, 6]], 3, temperature=temp)
    assert len(seen) == CFGS["dense"].num_layers * (1 + 2 * (3 + 2))
    assert all(isinstance(p, torch.Tensor) and p.shape == (2,) for p in seen)


def test_engine_step_carries_positions_on_the_device():
    """After generate, the step's positions stand at the prompt length plus
    the steps taken, in every row; the step is kept per (batch,
    temperature) and dropped with the cache when the batch changes."""
    eng = InferenceEngine(CFGS["dense"], seed=2, max_cache=32, device="cpu")
    eng.generate([[1, 2, 3, 4, 5]], 6)
    step = eng._graphs[(1, 0.0)]
    assert step.pos.tolist() == [5 + 5] and int(step.row) == 5
    eng.generate([[9, 9, 9]], 4)
    assert eng._graphs[(1, 0.0)] is step and step.pos.tolist() == [3 + 3]
    eng.generate([[1, 2], [3, 4]], 3)
    assert set(eng._graphs) == {(2, 0.0)}


def test_admission_keeps_the_static_token_and_position_buffers():
    srv = ContinuousServer(CFGS["dense"], slots=2, max_seq=32, seed=0, device="cpu")
    tok, pos = srv._tok_dev, srv._pos_dev
    assert tok is srv._step.tok and pos is srv._step.pos
    for i, prompt in enumerate(([1, 2, 3], [4, 5], [6, 7, 8, 9])):
        srv.submit(Request(rid=i, prompt=prompt, n_new=3))
    srv.prefill_pending()
    assert srv._tok_dev is tok and srv._pos_dev is pos
    assert pos.tolist() == [3, 2] and tok.tolist() == srv.last_tok.tolist()
    srv.run()
    assert srv._tok_dev is tok and srv._pos_dev is pos
    assert srv._step.tok is tok and srv._step.pos is pos


def test_run_takes_at_most_one_block():
    step = graphs.DecodeGraph(2, torch.device("cpu"),
                              lambda tok, pos: (tok + 1, tok + 1, pos + 1))
    step.start(torch.tensor([0, 10]), 3)
    toks = step.run(graphs.BLOCK)
    assert toks[:, 0].tolist() == list(range(1, graphs.BLOCK + 1))
    assert step.pos.tolist() == [3 + graphs.BLOCK] * 2 and int(step.row) == 0
    with pytest.raises(ValueError, match="at a time"):
        step.run(graphs.BLOCK + 1)


def test_replay_adds_the_captured_launches():
    """The wrappers tick at the call, which under capture reaches no card:
    the capture's increase is taken back, and each replay of the graph adds
    it.  A stub stands in for the CUDA graph."""
    class StubGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    calls = []

    def advance(tok, pos):     # what one step of a two-layer rwkv model ticks
        calls.append(1)
        wkv.launches += 2
        return tok, tok, pos + 1

    step = graphs.DecodeGraph(1, torch.device("cpu"), advance)
    before = {m: m.launches for m in (flash, fd, wkv)}
    stub = StubGraph()
    step.record(stub, contextlib.nullcontext())
    assert step.captured and len(calls) == 1
    assert {m: m.launches for m in (flash, fd, wkv)} == before
    assert step.added == {**dict.fromkeys(graphs.COUNTED, 0), wkv: 2}
    for _ in range(5):
        step.replay()
    assert stub.replays == 5 and len(calls) == 1
    assert wkv.launches == before[wkv] + 10
    assert (flash.launches, fd.launches) == (before[flash], before[fd])


def test_dropped_engine_and_server_leave_no_cycle():
    """The steps hold the weights and the cache, not their owner, so a
    dropped engine or server (and on the card its graph's memory pool) is
    freed at once, not at the next garbage collection."""
    import gc
    import weakref
    gc.disable()
    try:
        eng = InferenceEngine(CFGS["dense"], seed=0, max_cache=16, device="cpu")
        eng.generate([[1, 2, 3]], 3)
        srv = ContinuousServer(CFGS["dense"], slots=2, max_seq=16, params=eng.params,
                               device="cpu")
        refs = [weakref.ref(eng), weakref.ref(eng._graphs[(1, 0.0)]), weakref.ref(srv),
                weakref.ref(srv._step)]
        del eng, srv
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_capture_is_a_no_op_on_the_cpu():
    step = graphs.DecodeGraph(1, torch.device("cpu"), lambda t, p: (t, t, p))
    step.capture()
    assert not step.captured and step.added == {}


# ----------------------------------------------------------------------
# on the card: replayed tokens against the uncaptured step's
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _uncaptured():
    """New decode steps stay uncaptured and replay their step eagerly."""
    return mock.patch.object(graphs.DecodeGraph, "capture", lambda self: None)


def _card_engine(family, cuda, params=None):
    eng = InferenceEngine(CFGS[family], seed=0, max_cache=96, params=params, device=cuda)
    if family == "ssm" and params is None:
        gen = torch.Generator(device=cuda).manual_seed(1)
        d = CFGS[family].d_model
        for lp in eng.params["layers"]:
            lp["tmix"]["wo"]["w"] = torch.randn((d, d), generator=gen, device=cuda) * d ** -0.5
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(CFGS))
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_replayed_engine_tokens_equal_the_uncaptured_step(cuda, family, temperature):
    eng = _card_engine(family, cuda)
    prompt = np.random.default_rng(3).integers(0, 512, size=(3, 11))
    with _uncaptured():
        plain = _card_engine(family, cuda, params=eng.params)
        want = plain.generate(prompt, 70, temperature=temperature, seed=4).tokens
        assert plain.compile_stats()["graphs"] == 0
    kernel = wkv if family == "ssm" else fd
    n = kernel.launches
    got = eng.generate(prompt, 70, temperature=temperature, seed=4).tokens
    torch.cuda.synchronize()
    assert eng.compile_stats()["graphs"] == 1
    assert torch.equal(got, want)
    # the capture's warm-up step, then 69 replays; the rwkv prefill
    # launches K3 once a layer in its capture's warm-up and once a replay
    layers, prefill = CFGS[family].num_layers, int(family == "ssm")
    assert kernel.launches - n == layers * (1 + 69 + 2 * prefill)
    n = kernel.launches
    assert torch.equal(eng.generate_stream(prompt, 70, temperature=temperature,
                                           seed=4).tokens, want)
    assert kernel.launches - n == layers * (69 + prefill)


@pytest.mark.gpu
def test_replayed_server_tokens_equal_the_uncaptured_step(cuda):
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(4, 40))).tolist(),
             int(rng.integers(3, 70))) for i in range(8)]
    srv = ContinuousServer(CFGS["dense"], slots=4, max_seq=128, seed=0, device=cuda)
    plain = ContinuousServer(CFGS["dense"], slots=4, max_seq=128, params=srv.params,
                             device=cuda)

    def serve(server):
        for rid, prompt, n in reqs:
            server.submit(Request(rid=rid, prompt=prompt, n_new=n))
        return [(c.rid, c.tokens) for c in server.run()]

    with _uncaptured():
        want = serve(plain)
    assert serve(srv) == want
    assert srv.compile_stats()["graphs"] == 1 and plain.compile_stats()["graphs"] == 0
    n, steps = fd.launches, srv.steps
    assert serve(srv) == want             # the same graph, a second drain
    assert fd.launches - n == CFGS["dense"].num_layers * (srv.steps - steps)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [recurrentgemma_9b.SMOKE.replace(num_layers=5), whisper_tiny.SMOKE,
                                 llava_next_mistral_7b.SMOKE], ids=lambda c: c.family)
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_replayed_hybrid_audio_and_vlm_tokens_equal_the_uncaptured_path(cuda, cfg,
                                                                        temperature):
    """The last three families: the prefill (over the zero frame or patch
    embeddings for audio and vlm) and the step replayed, against the
    uncaptured path; llava's prefill is K1 and its step K2."""
    eng = InferenceEngine(cfg, seed=0, max_cache=64, device=cuda)
    prompt = np.random.default_rng(3).integers(0, 512, size=(3, 11))
    with mock.patch.object(graphs.CapturedStep, "capture", lambda self: None):
        plain = InferenceEngine(cfg, max_cache=64, params=eng.params, device=cuda)
        want = plain.generate(prompt, 40, temperature=temperature, seed=4).tokens
    n1, n2 = flash.launches, fd.launches
    got = eng.generate(prompt, 40, temperature=temperature, seed=4).tokens
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert eng.compile_stats()["graphs"] == 1 and eng.compile_stats()["prefill_graphs"] == 1
    # the prefill's capture warm-up and replay; the step's warm-up and 39 replays
    vlm = cfg.family == "vlm"
    assert flash.launches - n1 == 2 * cfg.num_layers * vlm
    assert fd.launches - n2 == 40 * cfg.num_layers * vlm


@pytest.mark.gpu
def test_servers_built_captured_and_dropped_leave_no_memory_behind(cuda):
    """Five smoke-width servers in turn, each seeding its own weights,
    draining four requests (its admission's and its step's captures) and
    dropped, as the replay's colds are: the allocated memory after the last
    is within 64 MiB of that after the first, no cuBLAS workspace cleared in
    between.  Every capture warms up on the device's one warm-up stream;
    a new stream a capture would leave a workspace behind each time."""
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, 512, size=int(rng.integers(4, 40))).tolist(), 5)
            for i in range(4)]
    after = []
    for seed in range(5):
        srv = ContinuousServer(CFGS["dense"], slots=2, max_seq=64, seed=seed, device=cuda)
        for rid, prompt, n in reqs:
            srv.submit(Request(rid=rid, prompt=prompt, n_new=n))
        assert len(srv.run()) == len(reqs)
        assert srv.compile_stats()["graphs"] == 1 and srv._admissions
        del srv
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(cuda))
    assert graphs.warm_up_stream(cuda) is graphs.warm_up_stream(cuda.index or 0)
    assert after[-1] - after[0] <= 64 * 2**20, [a / 2**20 for a in after]
