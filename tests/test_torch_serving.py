"""The port's serving path (engine, continuous server, sampler, batcher,
serve CLI) against the live reference on the same weights, on the CPU.

The reference's goldens depend on JAX's RNG default; these tests compare
with the reference's live output instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.serving import continuous as ref_continuous
from repro.serving import engine as ref_engine
from repro.serving import sampler as ref_sampler
from repro_torch.configs import deepseek_7b
from repro_torch.models.convert import from_reference
from repro_torch.serving.batcher import Batcher, PendingRequest
from repro_torch.serving.continuous import ContinuousServer, Request, _chunks
from repro_torch.serving.engine import InferenceEngine, bucket_len
from repro_torch.serving.sampler import gumbel, sample_token

REF_CFG = ARCHS["deepseek-7b"].smoke
CFG = deepseek_7b.SMOKE


def _port_params(ref_params):
    return from_reference(jax.tree_util.tree_map(np.asarray, ref_params), CFG, "cpu")


@pytest.fixture(scope="module")
def engines():
    """(reference engine, port engine on its converted weights)."""
    ref = ref_engine.InferenceEngine(REF_CFG, seed=0, max_cache=48)
    return ref, InferenceEngine(CFG, max_cache=48, params=_port_params(ref.params),
                                device="cpu")


def _cont_requests(n, seed=0, n_new=5):
    """The reference's ``test_serving_fast._cont_requests`` setup."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, CFG.vocab_size, size=int(rng.integers(4, 12))).tolist(),
             n_new) for i in range(n)]


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("prompt,n_new", [
    ([[3, 1, 4, 1, 5, 9, 2, 6]], 6),                 # exact bucket
    ([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]], 9),         # batch 2, padded to 8
    ([[11, 2, 40, 9, 3, 3, 1, 8, 30, 2, 5, 6, 7]], 12),   # padded 13 -> 16
])
def test_engine_greedy_tokens_equal_reference(engines, prompt, n_new):
    ref, eng = engines
    want = np.asarray(ref.generate(jnp.asarray(prompt, jnp.int32), n_new).tokens)
    got = eng.generate(np.asarray(prompt), n_new).tokens
    assert got.shape == (len(prompt), n_new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_stream_equals_generate(engines):
    _, eng = engines
    prompt = np.asarray([[7, 7, 2, 9, 1], [5, 0, 3, 3, 8]])
    for temp, seed in ((0.0, 0), (0.9, 11)):
        fused = eng.generate(prompt, 9, temperature=temp, seed=seed)
        stream = eng.generate_stream(prompt, 9, temperature=temp, seed=seed)
        assert torch.equal(fused.tokens, stream.tokens)
    assert stream.token_walls is not None and len(stream.token_walls) == 8
    assert fused.token_walls is None


def test_engine_bucketing_counts_shapes():
    """Prompt lengths 5/6/7 share the len-8 bucket: one prefill shape and
    one decode length; a new bucket adds exactly one prefill shape."""
    eng = InferenceEngine(CFG, seed=0, max_cache=32, device="cpu")
    for s in (5, 6, 7):
        eng.generate([[1] * s], 4)
    assert eng.compile_stats()["prefill"] == 1
    assert eng.compile_stats()["decode_scan"] == 1
    eng.generate([[1] * 12], 4)
    assert eng.compile_stats()["prefill"] == 2
    assert bucket_len(12) == 16 and eng._prefill_shapes(12, 4) == (16, 32)


def test_engine_reuses_its_preallocated_cache(engines):
    _, eng = engines
    eng.generate([[1, 2, 3]], 3)
    cache = eng._cache
    eng.generate([[4, 5, 6, 7]], 5)
    assert eng._cache is cache and cache["k"].shape[2] == eng.max_cache


def test_engine_warmup_and_stats():
    eng = InferenceEngine(CFG, seed=3, max_cache=32, device="cpu")
    assert eng.warmup(2, 8) >= 0 and eng.compiled
    stats = eng.stats()
    norms = (2 * CFG.num_layers + 1) * CFG.d_model      # the analytic count skips them
    assert stats["arch"] == CFG.name and stats["params"] == CFG.param_count() + norms


# ----------------------------------------------------------------------
# continuous server
# ----------------------------------------------------------------------

def _serve(srv, reqs, make):
    for rid, prompt, n_new in reqs:
        srv.submit(make(rid=rid, prompt=list(prompt), n_new=n_new))
    return srv.run()


@pytest.mark.parametrize("n_req,slots,max_seq,seed,n_new", [
    (7, 3, 48, 0, 5),      # the reference's pinned setup
    (6, 3, 48, 42, 7),
    (5, 2, 16, 1, 9),      # the cache runs out before the budget
])
def test_continuous_server_equals_reference(n_req, slots, max_seq, seed, n_new):
    reqs = _cont_requests(n_req, seed, n_new)
    ref = ref_continuous.ContinuousServer(REF_CFG, slots=slots, max_seq=max_seq, seed=0)
    srv = ContinuousServer(CFG, slots=slots, max_seq=max_seq,
                           params=_port_params(ref.params), device="cpu")
    want = _serve(ref, reqs, ref_continuous.Request)
    got = _serve(srv, reqs, Request)
    assert [c.rid for c in got] == [c.rid for c in want]
    assert {c.rid: c.tokens for c in got} == {c.rid: c.tokens for c in want}
    assert [c.steps_in_flight for c in got] == [c.steps_in_flight for c in want]
    assert srv.steps == ref.steps


def test_continuous_fused_matches_per_step():
    reqs = _cont_requests(6, seed=42, n_new=7)
    fast = ContinuousServer(CFG, slots=3, max_seq=48, seed=0, device="cpu")
    slow = ContinuousServer(CFG, slots=3, max_seq=48, params=fast.params, device="cpu")
    fast_done = {c.rid: c.tokens for c in _serve(fast, reqs, Request)}
    for rid, prompt, n_new in reqs:
        slow.submit(Request(rid, list(prompt), n_new))
    while slow.queue or slow.active.any():
        slow.prefill_pending()
        if slow.active.any():
            slow.step()
    assert fast_done == {c.rid: c.tokens for c in slow._done}
    assert fast.steps == slow.steps


def test_continuous_admission_reuses_shapes():
    srv = ContinuousServer(CFG, slots=4, max_seq=64, seed=0, device="cpu")
    for i in range(4):
        srv.submit(Request(rid=i, prompt=[1 + i] * (5 + i), n_new=4))
    srv.run()
    first = srv.compile_stats()
    assert first["prefill"] == 1               # lengths 5-8 share bucket 8
    for i in range(4):
        srv.submit(Request(rid=10 + i, prompt=[2 + i] * (5 + i), n_new=4))
    srv.run()
    assert srv.compile_stats() == first


def test_continuous_exact_admission_matches_bucketed():
    """Per-request exact-length admission (the path of families whose pad
    tokens would change real tokens) gives the bucketed round's logits and
    the same cache rows at every prompt position."""
    srv = ContinuousServer(CFG, slots=3, max_seq=32, seed=0, device="cpu")
    reqs = [Request(rid=i, prompt=p, n_new=2) for i, (_, p, _) in
            enumerate(_cont_requests(3, seed=4))]
    b_logits, b_rows = srv._prefill_bucketed(reqs)
    # both write the one staging cache, whose rows hold until the next round
    b_logits, b_rows = b_logits.clone(), {n: t.clone() for n, t in b_rows.items()}
    e_logits, e_rows = srv._prefill_exact(reqs)
    torch.testing.assert_close(e_logits, b_logits, atol=1e-5, rtol=1e-5)
    assert e_rows["k"].shape[:3] == (CFG.num_layers, 3, srv.max_seq)
    for j, r in enumerate(reqs):
        n = len(r.prompt)
        for name in ("k", "v"):
            torch.testing.assert_close(e_rows[name][:, j, :n], b_rows[name][:, j, :n],
                                       atol=1e-5, rtol=1e-5)
            assert not e_rows[name][:, j, n:].any()


def test_continuous_slot_reuse_and_varied_lengths():
    reqs = [(0, [1, 2, 3], 2), (1, [4, 5], 8), (2, [6], 1), (3, [7, 8, 9, 10], 4)]
    srv = ContinuousServer(CFG, slots=2, max_seq=32, seed=0, device="cpu")
    done = {c.rid: c.tokens for c in _serve(srv, reqs, Request)}
    assert {rid: len(t) for rid, t in done.items()} == {0: 2, 1: 8, 2: 1, 3: 4}


def test_continuous_inactive_slots_keep_writing_at_their_frozen_position():
    """A finished slot still writes KV at its frozen position each step, as
    the reference's per-row scatter does; the writes land past every live
    position of that slot and the next admission's scatter overwrites them."""
    srv = ContinuousServer(CFG, slots=2, max_seq=32, seed=0, device="cpu")
    srv.submit(Request(0, [1, 2, 3], n_new=2))
    srv.submit(Request(1, [4, 5, 6], n_new=6))
    srv.run()
    frozen = int(srv._pos_dev[0])
    assert frozen == 4                          # 3 prompt + 1 decoded position
    assert srv.cache["k"][:, 0, frozen].abs().sum() > 0


def test_continuous_n_active_counts_the_slots_in_flight_as_the_reference():
    """Admission fills free slots, a finished sequence frees its slot, and
    the queue refills it: the count follows the reference's step by step."""
    ref = ref_continuous.ContinuousServer(REF_CFG, slots=3, max_seq=32, seed=0)
    srv = ContinuousServer(CFG, slots=3, max_seq=32, params=_port_params(ref.params),
                           device="cpu")
    reqs = [(0, [1, 2, 3], 2), (1, [4, 5], 4), (2, [6, 7, 8, 9], 1), (3, [3, 3], 3),
            (4, [5], 2)]
    for server, cls in ((ref, ref_continuous.Request), (srv, Request)):
        assert server.n_active() == 0
        for rid, prompt, n_new in reqs:
            server.submit(cls(rid=rid, prompt=prompt, n_new=n_new))
    counts = []
    for server in (ref, srv):
        server.prefill_pending()
        seen = [server.n_active()]
        for _ in range(4):
            server.step()
            seen.append(server.n_active())
            server.prefill_pending()
            seen.append(server.n_active())
        counts.append(seen)
    assert counts[0] == counts[1]
    assert counts[1][0] == 2 and max(counts[1]) == 3 and counts[1][-1] < 3


def test_chunk_decomposition():
    assert list(_chunks(7)) == [4, 2, 1]
    assert list(_chunks(200)) == [64, 64, 64, 8]
    assert sum(_chunks(1337)) == 1337


# ----------------------------------------------------------------------
# sampler and batcher
# ----------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 1, 5, 64])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sampler_with_injected_noise_equals_categorical(top_k, temperature):
    """jax.random.categorical is an argmax over logits plus Gumbel noise:
    handed the reference's noise, the port draws the reference's tokens."""
    logits = np.random.default_rng(5).standard_normal((6, 257)).astype(np.float32) * 3
    key = jax.random.PRNGKey(9)
    want = ref_sampler.sample_token(jnp.asarray(logits), temperature, key, top_k=top_k)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = sample_token(torch.from_numpy(logits), temperature, top_k=top_k,
                       noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_greedy_and_generator_draws():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 50))
                              .astype(np.float32))
    assert torch.equal(sample_token(logits, 0.0), logits.argmax(-1))
    a = sample_token(logits, 1.0, torch.Generator().manual_seed(3), top_k=5)
    b = sample_token(logits, 1.0, torch.Generator().manual_seed(3), top_k=5)
    assert torch.equal(a, b)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert bool((top5 == a[:, None]).any(-1).all())
    with pytest.raises(ValueError, match="generator"):
        sample_token(logits, 1.0)
    g = gumbel((20000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(g).all() and abs(g.mean().item() - 0.5772) < 0.05


def test_batcher_per_request_budgets():
    b = Batcher(max_batch=4, max_wait_s=0.0)
    asks = [2, 16, 5, 9]
    for i, n in enumerate(asks):
        b.submit(PendingRequest(rid=i, tokens=[1] * (3 + i), arrival_s=0.0, n_new=n))
    batch = b.form_batch(1.0)
    assert batch.n_new == 16 and batch.n_new_each == asks
    assert batch.tokens.shape == (4, 6) and list(batch.lengths) == [3, 4, 5, 6]


def test_serve_cli_serves_every_request_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "deepseek-7b", "--smoke", "--requests", "5",
                       "--n-new", "3", "--device", "cpu"])
    assert sorted(outs) == list(range(5))
    assert all(len(t) == 3 for t in outs.values())
    assert "5 requests served (15 tokens)" in capsys.readouterr().out
