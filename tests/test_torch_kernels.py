"""The port's kernels: plain versions against the reference's Pallas kernels
(interpret mode on the CPU), device dispatch, and, on a card, the Hopper
kernels against their plain versions (``pytest -m gpu``)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.decode.ref import flash_decode_ref
from repro_torch.kernels.rwkv import wkv
from repro_torch.kernels.rwkv.ref import wkv6_ref

F32_TOL = 2e-5    # same algorithm, float32: summation order only
BF16_TOL = 2e-2   # the reference kernel keeps probabilities in float32, the
                  # plain version casts them to bf16 before PV
GPU_F32_TOL = 1e-4  # kernel vs plain on the card: another summation order
WKV_TOL = 2e-5    # float32 recurrence, summation order only; the state
                  # reaches tens, so the relative part of the bound carries it


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas kernels (interpret mode) and sdpa, on JAX's
    CPU backend.  Imported here, not at the top: the card's machine runs
    this file's gpu tests without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.attention.ops import flash_attention
    from repro.kernels.decode.ops import flash_decode
    from repro.kernels.rwkv.ops import wkv6
    from repro.models.layers import sdpa
    return SimpleNamespace(jnp=jnp, flash_attention=flash_attention,
                           flash_decode=flash_decode, wkv6=wkv6, sdpa=sdpa)


def _both(ref, a, dtype):
    """The same numbers as a JAX array and a torch tensor of one dtype."""
    t = torch.from_numpy(a).to(dtype)
    jdt = ref.jnp.bfloat16 if dtype == torch.bfloat16 else ref.jnp.float32
    return ref.jnp.asarray(a).astype(jdt), t


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
# K1 plain version vs Pallas (interpret)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,hd", [
    (2, 256, 4, 2, 64),     # GQA
    (1, 128, 4, 4, 128),    # MHA, wide head
    (1, 256, 4, 1, 32),     # MQA
    (1, 300, 2, 2, 64),     # ragged S (reference pads, port masks)
    (1, 384, 2, 1, 32),     # ragged S, several blocks
])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_plain_matches_pallas(ref, b, s, h, kh, hd, window):
    q, tq = _both(ref, _rand((b, s, h, hd), 1), torch.float32)
    k, tk = _both(ref, _rand((b, s, kh, hd), 2), torch.float32)
    v, tv = _both(ref, _rand((b, s, kh, hd), 3), torch.float32)
    want = ref.flash_attention(q, k, v, window=window, interpret=True)
    _close(flash_attention_ref(tq, tk, tv, window=window), want, F32_TOL)


@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_plain_matches_pallas_bf16(ref, window):
    q, tq = _both(ref, _rand((1, 256, 4, 64), 1), torch.bfloat16)
    k, tk = _both(ref, _rand((1, 256, 2, 64), 2), torch.bfloat16)
    v, tv = _both(ref, _rand((1, 256, 2, 64), 3), torch.bfloat16)
    want = ref.flash_attention(q, k, v, window=window, interpret=True)
    _close(flash_attention_ref(tq, tk, tv, window=window), want, BF16_TOL)


# ----------------------------------------------------------------------
# K2 plain version vs Pallas (interpret), (S,) form, and (B,S) vs sdpa
# ----------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,hd", [
    (2, 1024, 4, 2, 64),    # GQA
    (1, 512, 8, 8, 128),    # MHA
    (3, 768, 4, 1, 64),     # MQA
    (1, 300, 2, 2, 64),     # ragged S
])
def test_flash_decode_plain_matches_pallas(ref, b, s, h, kh, hd):
    q, tq = _both(ref, _rand((b, 1, h, hd), 1), torch.float32)
    k, tk = _both(ref, _rand((b, s, kh, hd), 2), torch.float32)
    v, tv = _both(ref, _rand((b, s, kh, hd), 3), torch.float32)
    valid = np.arange(s) <= (3 * s) // 4
    want = ref.flash_decode(q, k, v, ref.jnp.asarray(valid), interpret=True)
    _close(flash_decode_ref(tq, tk, tv, torch.from_numpy(valid)), want, F32_TOL)


def test_flash_decode_plain_matches_pallas_bf16(ref):
    q, tq = _both(ref, _rand((2, 1, 4, 64), 1), torch.bfloat16)
    k, tk = _both(ref, _rand((2, 512, 2, 64), 2), torch.bfloat16)
    v, tv = _both(ref, _rand((2, 512, 2, 64), 3), torch.bfloat16)
    valid = np.arange(512) < 300
    want = ref.flash_decode(q, k, v, ref.jnp.asarray(valid), interpret=True)
    _close(flash_decode_ref(tq, tk, tv, torch.from_numpy(valid)), want, BF16_TOL)


@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (3, 48, 4, 4, 32, 0),      # the continuous server's smoke shape
    (4, 300, 8, 2, 64, 0),     # GQA, ragged
    (2, 256, 4, 1, 64, 64),    # MQA, windowed per-row band
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_decode_per_row_mask_matches_sdpa(ref, b, s, h, kh, hd, window, dtype, tol):
    q, tq = _both(ref, _rand((b, 1, h, hd), 4), dtype)
    k, tk = _both(ref, _rand((b, s, kh, hd), 5), dtype)
    v, tv = _both(ref, _rand((b, s, kh, hd), 6), dtype)
    pos = np.random.default_rng(7).integers(0, s, size=b)
    kv = np.arange(s)
    valid = kv[None, :] <= pos[:, None]
    if window:
        valid &= (pos[:, None] - kv[None, :]) < window
    want = ref.sdpa(q, k, v, ref.jnp.asarray(valid)[:, None, :])
    _close(flash_decode_ref(tq, tk, tv, torch.from_numpy(valid)), want, tol)


def test_flash_decode_plain_all_false_mask_matches_pallas_mean_of_v(ref):
    """A row with no valid position: the Pallas kernel softmaxes equal -1e30
    logits, which weighs every position alike, so the output is the mean of
    V over the whole cache.  The plain version gives the same, and the
    Hopper kernel (which skips masked tiles only in rows that have a valid
    position) is held to it on the card."""
    q, tq = _both(ref, _rand((2, 1, 4, 64), 1), torch.float32)
    k, tk = _both(ref, _rand((2, 256, 2, 64), 2), torch.float32)
    v, tv = _both(ref, _rand((2, 256, 2, 64), 3), torch.float32)
    valid = np.zeros(256, dtype=bool)
    want = ref.flash_decode(q, k, v, ref.jnp.asarray(valid), interpret=True)
    got = flash_decode_ref(tq, tk, tv, torch.from_numpy(valid))
    _close(got, want, F32_TOL)
    mean_v = tv.mean(dim=1).repeat_interleave(2, dim=1)[:, None]   # (B,1,H,hd)
    _close(got, mean_v.numpy(), F32_TOL)


def _masked_logsumexp(ref, q, k, valid):
    """jax.nn.logsumexp of the reference's masked logits (its sdpa's
    float32 q.k * hd^-0.5, -1e30 where masked), (B,H)."""
    import jax
    jnp = ref.jnp
    g = q.shape[2] // k.shape[2]
    kk = jnp.repeat(k.astype(jnp.float32), g, axis=2)
    logits = jnp.einsum("bqhd,bshd->bhqs", q.astype(jnp.float32), kk) * q.shape[-1] ** -0.5
    logits = jnp.where(jnp.asarray(valid)[:, None, None, :], logits, -1e30)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)[:, :, 0])


@pytest.mark.parametrize("b,s,h,kh,hd", [(3, 256, 4, 2, 64), (3, 300, 8, 8, 32),
                                         (3, 128, 4, 1, 128)])
def test_flash_decode_plain_lse_matches_jax_logsumexp(ref, b, s, h, kh, hd):
    """K2's plain version with ``return_lse``: each row's log-sum-exp equals
    ``jax.nn.logsumexp`` of the reference's masked logits, -inf for a row
    with no valid position (row 1), and the output equals the one without
    it."""
    q, tq = _both(ref, _rand((b, 1, h, hd), 11), torch.float32)
    k, tk = _both(ref, _rand((b, s, kh, hd), 12), torch.float32)
    _, tv = _both(ref, _rand((b, s, kh, hd), 13), torch.float32)
    pos = np.random.default_rng(14).integers(0, s, size=b)
    valid = np.arange(s)[None, :] <= pos[:, None]
    valid[1] = False
    o, lse = flash_decode_ref(tq, tk, tv, torch.from_numpy(valid), return_lse=True)
    assert lse.shape == (b, h) and lse.dtype == torch.float32
    assert torch.equal(o, flash_decode_ref(tq, tk, tv, torch.from_numpy(valid)))
    want = _masked_logsumexp(ref, q, k, valid)
    rows = [0, 2]
    _close(lse[rows], want[rows], F32_TOL)
    assert torch.isneginf(lse[1]).all()


@pytest.mark.parametrize("mask", ["both halves", "first half", "second half", "none"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_two_combined_cache_halves_match_pallas_on_the_whole_cache(ref, mask, dtype, tol):
    """A cache cut at S/2 as two ranks hold it: K2's plain version on each
    half with its row log-sum-exp, combined (``shardctx.merge_softmax``, the
    arithmetic of ``combine_softmax``), against the reference's Pallas
    kernel on the whole cache; with no valid position anywhere, both give
    the mean of V."""
    from repro_torch import shardctx
    b, s, h, kh, hd = 2, 512, 4, 2, 64
    q, tq = _both(ref, _rand((b, 1, h, hd), 21), dtype)
    k, tk = _both(ref, _rand((b, s, kh, hd), 22), dtype)
    v, tv = _both(ref, _rand((b, s, kh, hd), 23), dtype)
    lo, hi = {"both halves": (100, 400), "first half": (3, 200), "second half": (300, 511),
              "none": (0, -1)}[mask]
    valid = (np.arange(s) >= lo) & (np.arange(s) <= hi)
    want = ref.flash_decode(q, k, v, ref.jnp.asarray(valid), interpret=True)
    tvalid = torch.from_numpy(valid)
    parts = [flash_decode_ref(tq, tk[:, i:i + s // 2], tv[:, i:i + s // 2],
                              tvalid[i:i + s // 2], return_lse=True) for i in (0, s // 2)]
    got = shardctx.merge_softmax([o for o, _ in parts], [lse for _, lse in parts])
    _close(got, want, tol)


def test_combined_halves_with_a_row_without_valid_positions_match_jax_sdpa(ref):
    """Per-row masks over two halves, one row with no valid position in
    either, one with valid positions in the second half only: the combined
    halves equal the reference's ``flash_decode_ref`` (its sdpa) on the
    whole cache row by row, the empty row the mean of V."""
    from repro.kernels.decode.ref import flash_decode_ref as jax_decode_ref
    from repro_torch import shardctx
    b, s, h, kh, hd = 3, 256, 4, 4, 32
    q, tq = _both(ref, _rand((b, 1, h, hd), 31), torch.float32)
    k, tk = _both(ref, _rand((b, s, kh, hd), 32), torch.float32)
    v, tv = _both(ref, _rand((b, s, kh, hd), 33), torch.float32)
    kv = np.arange(s)
    valid = np.stack([kv <= 40, np.zeros(s, bool), (kv >= 150) & (kv <= 200)])
    tvalid = torch.from_numpy(valid)
    parts = [flash_decode_ref(tq, tk[:, i:i + s // 2], tv[:, i:i + s // 2],
                              tvalid[:, i:i + s // 2], return_lse=True) for i in (0, s // 2)]
    got = shardctx.merge_softmax([o for o, _ in parts], [lse for _, lse in parts])
    for r in range(b):
        want = jax_decode_ref(q[r:r + 1], k[r:r + 1], v[r:r + 1], ref.jnp.asarray(valid[r]))
        _close(got[r:r + 1], want, F32_TOL)
    _close(got[1], tv[1].mean(dim=0)[None].numpy(), F32_TOL)


def test_flash_decode_shared_mask_equals_per_row_broadcast():
    tq, tk, tv = (torch.from_numpy(_rand(sh, i)) for i, sh in
                  enumerate([(2, 1, 4, 32), (2, 100, 2, 32), (2, 100, 2, 32)]))
    valid = torch.arange(100) < 70
    shared = flash_decode_ref(tq, tk, tv, valid)
    per_row = flash_decode_ref(tq, tk, tv, valid[None].expand(2, 100))
    assert torch.equal(shared, per_row)


# ----------------------------------------------------------------------
# K3 plain version vs Pallas (interpret)
# ----------------------------------------------------------------------

def _wkv_inputs(b, t, h, hd, seed=0, log_decay=-2.0):
    """The reference test's inputs (``test_kernels.py``): realistic decays
    w = exp(-exp(randn + log_decay)), a bonus u and a small initial state.
    ``log_decay`` near +2 gives decays near 0, near -6 decays near 1."""
    shape = (b, t, h, hd)
    r, k, v = (_rand(shape, seed + i) for i in range(3))
    w = np.exp(-np.exp(_rand(shape, seed + 3) + log_decay)).astype(np.float32)
    u = _rand((h, hd), seed + 4) * 0.5
    s0 = _rand((b, h, hd, hd), seed + 5) * 0.1
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,t,h,hd", [
    (2, 128, 2, 32),
    (1, 64, 4, 64),
    (2, 96, 2, 32),      # the reference pads T to its 64-step chunks
    (1, 256, 1, 16),
    (4, 1, 2, 64),       # one decode step
    (2, 100, 2, 64),     # the engine's prefill length, ragged for the reference
])
def test_wkv6_plain_matches_pallas(ref, b, t, h, hd):
    arrays = _wkv_inputs(b, t, h, hd)
    o, s = ref.wkv6(*(ref.jnp.asarray(a) for a in arrays), interpret=True)
    got_o, got_s = wkv6_ref(*(torch.from_numpy(a) for a in arrays))
    _close(got_o, o, WKV_TOL)
    _close(got_s, s, WKV_TOL)


def test_wkv6_plain_state_chaining_matches_pallas(ref):
    """Two halves with the state carried equal the whole sequence, and the
    Pallas kernel's final state."""
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _wkv_inputs(1, 128, 2, 32))
    s0 = torch.zeros((1, 2, 32, 32))
    o_full, s_full = wkv6_ref(r, k, v, w, u, s0)
    o1, s1 = wkv6_ref(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u, s0)
    o2, s2 = wkv6_ref(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 1), o_full, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(s2, s_full, atol=WKV_TOL, rtol=WKV_TOL)
    _, want = ref.wkv6(*(ref.jnp.asarray(a.numpy()) for a in (r, k, v, w, u, s0)),
                       interpret=True)
    _close(s2, want, WKV_TOL)


def test_wkv6_plain_leaves_the_initial_state_alone():
    arrays = [torch.from_numpy(a) for a in _wkv_inputs(1, 8, 2, 16)]
    s0 = arrays[-1].clone()
    wkv6_ref(*arrays)
    assert torch.equal(arrays[-1], s0)


# ----------------------------------------------------------------------
# dispatch and wrappers on the CPU
# ----------------------------------------------------------------------

def test_dispatch_takes_plain_versions_on_cpu_without_counting():
    before = (flash.launches, fd.launches)
    tq, tk, tv = (torch.from_numpy(_rand(sh, i)) for i, sh in
                  enumerate([(1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)]))
    assert torch.equal(dispatch.flash_attention(tq, tk, tv, window=8),
                       flash_attention_ref(tq, tk, tv, window=8))
    valid = torch.arange(40) < 30
    q1 = tq[:, :1].contiguous()
    assert torch.equal(dispatch.flash_decode(q1, tk, tv, valid),
                       flash_decode_ref(q1, tk, tv, valid))
    for got, want in zip(dispatch.flash_decode(q1, tk, tv, valid, return_lse=True),
                         flash_decode_ref(q1, tk, tv, valid, return_lse=True)):
        assert torch.equal(got, want)
    assert (flash.launches, fd.launches) == before


def test_dispatch_takes_the_plain_wkv6_on_cpu_without_counting():
    before = wkv.launches
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(2, 12, 2, 32))
    want_o, want_s = wkv6_ref(r, k, v, w, u, s0)
    o, s = dispatch.rwkv_scan(r, k, v, w, u, s0)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    state = s0.clone()
    o, s = dispatch.rwkv_scan(r, k, v, w, u, state, out_state=state)
    assert s is state and torch.equal(state, want_s) and torch.equal(o, want_o)
    assert wkv.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    t = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(t[:, :1], t, t, torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        wkv.wkv6(t, t, t, t, torch.zeros((2, 32)), torch.zeros((1, 2, 32, 32)))


@pytest.mark.parametrize("b,kh,s", [(1, 1, 1), (4, 32, 256), (4, 32, 512),
                                     (1, 8, 1024), (64, 32, 2048), (3, 4, 300)])
def test_split_plan_covers_every_tile_once(b, kh, s):
    splits, per = fd.split_plan(b, kh, s)
    tiles = -(-s // fd.TILE)
    assert splits * per >= tiles > (splits - 1) * per    # no empty split
    assert splits == 1 or b * kh * (splits - 1) < fd.CTAS_PER_SM * fd.SMS


@pytest.mark.parametrize("hd", wkv.HEAD_DIMS)
def test_wkv6_split_plan_covers_every_column_once(hd):
    """For every B*H from 1 to 128, the grid of B*H*P CTAs (CTA id = bh * P
    + p, columns p*cols .. p*cols + cols - 1) covers each column of each
    (b, h) exactly once, with CTAs the kernel takes: whole warps (or the
    whole head, where it is smaller), at most THREADS threads, lanes of ROWS
    rows and COLS columns each."""
    p, cols, lanes = wkv.split_plan(hd)
    assert lanes * wkv.ROWS == hd and p * cols == hd
    assert cols & (cols - 1) == 0 and wkv.COLS <= cols
    threads = cols // wkv.COLS * lanes
    assert threads == wkv.THREADS or (cols == hd and threads < wkv.THREADS)
    for bh in range(1, 129):
        seen = np.zeros((bh, hd), np.int64)
        for cta in range(bh * p):
            seen[cta // p, cta % p * cols:(cta % p + 1) * cols] += 1
        assert (seen == 1).all()
    if hd == 64:   # the rwkv6-1.6b engine: more CTAs than B*H = 128
        assert (p, cols, lanes) == (2, 32, 16)


@pytest.mark.parametrize("hd", wkv.HEAD_DIMS)
def test_wkv6_bwd_split_plan_covers_every_column_once(hd):
    """For every B*H from 1 to 128, K3-bwd's plan puts each column of each
    (b, h) in exactly one CTA (CTA id = bh * P + p, columns p*cols ..
    p*cols + cols - 1), a head's CTAs in one cluster of at most 8, with
    CTAs the kernel takes: 32 columns, or the whole narrower head, in whole
    warps (or the whole head's 16 threads)."""
    from repro_torch.kernels.rwkv import wkv_bwd
    p, cols = wkv_bwd.split_plan(hd)
    assert p * cols == hd and 1 <= p <= 8 and cols == min(hd, wkv_bwd.CTA_COLS)
    n = wkv_bwd.threads(hd)
    assert n == cols // wkv.COLS * hd // wkv.ROWS and (n % 32 == 0 or n == 16)
    for heads in range(1, 129):
        seen = np.zeros((heads, hd), np.int64)
        for cta in range(heads * p):
            seen[cta // p, cta % p * cols:(cta % p + 1) * cols] += 1
        assert (seen == 1).all()
    if hd == 64:   # rwkv6-1.6b's train step: B*H = 128 heads, 256 CTAs
        assert (p, cols, n) == (2, 32, 128)


@pytest.mark.parametrize("b,t,h,hd", [(4, 512, 32, 64), (2, 37, 4, 64), (1, 33, 1, 16),
                                      (2, 100, 8, 128), (3, 16, 5, 32), (1, 1, 1, 64)])
def test_wkv6_bwd_scratch_follows_from_the_plan(b, t, h, hd):
    """The wrapper's scratch: a checkpoint slot of hd*hd floats per (b, h)
    and chunk of 16 steps (the CTAs' threads hold hd*hd/16 blocks of 16),
    and one du share per CTA thread, the thread summing row (p * threads +
    tid) % hd, so that du_sum's hd/16 shares a row of each (b, h) cover its
    threads once."""
    from repro_torch.kernels.rwkv import wkv_bwd
    p, cols = wkv_bwd.split_plan(hd)
    n = wkv_bwd.threads(hd)
    sizes = wkv_bwd.scratch_numel(b, t, h, hd)
    assert sizes["ckpt"] == b * h * -(-t // wkv_bwd.CHUNK) * hd * hd
    assert sizes["du_part"] == b * h * p * n == b * h * hd * hd // 16
    rows = np.array([(q * n + tid) % hd for q in range(p) for tid in range(n)])
    assert (np.bincount(rows, minlength=hd) == hd // 16).all()
    assert all(rows[i + m * hd] == i for i in range(hd) for m in range(hd // 16))


def test_build_targets_hopper_from_repo_sources():
    assert build.sources() == ["adamw", "flash_attention", "flash_attention_bwd", "flash_decode",
                               "wkv6", "wkv6_bwd"]
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS
    for name in build.sources():
        path = build.target(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(name + "-")
        assert (build.CSRC / f"{name}.cu").read_text().count("extern \"C\"") == 1


def test_build_target_changes_with_a_shared_header(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` gives every source a new library path, so a
    library built against the old header is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.target(name) for name in build.sources()}
    header = csrc / "common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: build.target(name) for name in build.sources()}
    assert all(after[name] != before[name] for name in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.target("flash_decode") != after["flash_decode"]


# ----------------------------------------------------------------------
# on the card: the Hopper kernels against their plain versions
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _dev(a, dtype, dev):
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (4, 128, 32, 32, 128, 0),   # the engine's prefill shape
    (4, 512, 32, 32, 128, 0),   # the continuous server's prefill shape
    (2, 256, 8, 2, 64, 0),      # GQA
    (1, 300, 4, 1, 128, 0),     # MQA, ragged S
    (1, 256, 4, 4, 128, 64),    # window
    (2, 70, 4, 4, 32, 0),       # smoke head dim, ragged
    (1, 300, 8, 2, 64, 0),      # head dim 64, ragged
    (2, 333, 4, 2, 32, 100),    # head dim 32, ragged, window across tiles
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, kh, hd, window, dtype, tol):
    q = _dev(_rand((b, s, h, hd), 1), dtype, cuda)
    k = _dev(_rand((b, s, kh, hd), 2), dtype, cuda)
    v = _dev(_rand((b, s, kh, hd), 3), dtype, cuda)
    n = flash.launches
    got = flash.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash.launches == n + 1
    want = flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kh,hd,per_row", [
    (4, 256, 32, 32, 128, False),   # the engine's decode shape, (S,) mask
    (4, 512, 32, 32, 128, True),    # the server's decode shape, (B,S) mask
    (2, 1024, 8, 2, 64, False),     # GQA
    (3, 300, 4, 1, 64, True),       # MQA, ragged S
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_decode_kernel_matches_plain(cuda, b, s, h, kh, hd, per_row, dtype, tol):
    q = _dev(_rand((b, 1, h, hd), 1), dtype, cuda)
    k = _dev(_rand((b, s, kh, hd), 2), dtype, cuda)
    v = _dev(_rand((b, s, kh, hd), 3), dtype, cuda)
    kv = torch.arange(s, device=cuda)
    if per_row:
        pos = torch.tensor(np.random.default_rng(0).integers(0, s, size=b), device=cuda)
        valid = kv[None, :] <= pos[:, None]
    else:
        valid = kv <= (2 * s) // 3
    n = fd.launches
    got = fd.flash_decode(q, k, v, valid)
    torch.cuda.synchronize()
    assert fd.launches == n + 1
    want = flash_decode_ref(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kh,hd", [(1, 8192, 32, 32, 128), (4, 512, 64, 4, 128),
                                         (3, 300, 8, 2, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_decode_kernel_lse_matches_plain(cuda, b, s, h, kh, hd, dtype, tol):
    """K2 with ``return_lse``: o bit-equal to K2's without it, each row's
    log-sum-exp against the plain version's (float32 either way), -inf for
    a row with no valid position."""
    q = _dev(_rand((b, 1, h, hd), 1), dtype, cuda)
    k = _dev(_rand((b, s, kh, hd), 2), dtype, cuda)
    v = _dev(_rand((b, s, kh, hd), 3), dtype, cuda)
    pos = torch.tensor(np.random.default_rng(0).integers(0, s, size=b), device=cuda)
    valid = torch.arange(s, device=cuda)[None, :] <= pos[:, None]
    valid[-1] = False
    n = fd.launches
    o, lse = fd.flash_decode(q, k, v, valid, return_lse=True)
    plain = fd.flash_decode(q, k, v, valid)
    torch.cuda.synchronize()
    assert fd.launches == n + 2
    assert torch.equal(o, plain)
    want_o, want = flash_decode_ref(q, k, v, valid, return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse[:-1], want[:-1], atol=GPU_F32_TOL, rtol=GPU_F32_TOL)
    assert torch.isneginf(lse[-1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_decode_kernel_takes_a_band_slice_without_copy(cuda, dtype, tol):
    cache_k = _dev(_rand((2, 512, 4, 64), 2), dtype, cuda)
    cache_v = _dev(_rand((2, 512, 4, 64), 3), dtype, cuda)
    q = _dev(_rand((2, 1, 8, 64), 1), dtype, cuda)
    band_k, band_v = cache_k[:, 100:228], cache_v[:, 100:228]
    valid = torch.arange(128, device=cuda) < 90
    got = fd.flash_decode(q, band_k, band_v, valid)
    want = flash_decode_ref(q, band_k, band_v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _skip_masks(s, dev):
    """(4,S) masks whose all-false 64-position tiles lie at the start (row 0),
    around a window band (row 1), in the middle (row 2) and at the end (row 3)."""
    kv = torch.arange(s, device=dev)
    return torch.stack([kv >= s - 200,
                        (kv >= 200) & (kv < 264),
                        (kv < 70) | ((kv >= s - 100) & (kv < s - 50)),
                        kv <= 100])


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,kh,hd", [
    (512, 32, 32, 128),    # the continuous server's cache
    (700, 8, 2, 64),       # GQA, ragged S
    (448, 12, 1, 32),      # MQA with 12 heads: two head chunks per kv head
    (320, 4, 2, 256),      # the widest head dim: two 16-byte vectors per lane in float32
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_decode_kernel_skips_masked_tiles(cuda, s, h, kh, hd, dtype, tol):
    q = _dev(_rand((4, 1, h, hd), 1), dtype, cuda)
    k = _dev(_rand((4, s, kh, hd), 2), dtype, cuda)
    v = _dev(_rand((4, s, kh, hd), 3), dtype, cuda)
    valid = _skip_masks(s, cuda)
    got = fd.flash_decode(q, k, v, valid)
    want = flash_decode_ref(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("form", ["(S,)", "(B,S)"])
def test_flash_decode_kernel_all_false_row_is_the_mean_of_v(cuda, dtype, tol, form):
    """A row with no valid position reads every position, as the reference
    does, while the other rows skip their masked tiles."""
    b, s, h, kh, hd = 3, 300, 8, 8, 128
    q = _dev(_rand((b, 1, h, hd), 1), dtype, cuda)
    k = _dev(_rand((b, s, kh, hd), 2), dtype, cuda)
    v = _dev(_rand((b, s, kh, hd), 3), dtype, cuda)
    if form == "(S,)":
        valid = torch.zeros(s, dtype=torch.bool, device=cuda)
        empty = list(range(b))
    else:
        valid = torch.arange(s, device=cuda)[None, :] <= torch.tensor([[40], [0], [250]],
                                                                      device=cuda)
        valid[1] = False
        empty = [1]
    got = fd.flash_decode(q, k, v, valid)
    want = flash_decode_ref(q, k, v, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    mean_v = v.float().mean(dim=1)[:, None]
    torch.testing.assert_close(got[empty].float(), mean_v[empty], atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,hd,log_decay", [
    (4, 100, 32, 64, -2.0),    # the engine's prefill at full width
    (4, 1, 32, 64, -2.0),      # its decode step
    (1, 2048, 32, 64, -2.0),   # a long prompt
    (2, 96, 2, 32, -2.0),
    (1, 256, 1, 16, -2.0),
    (2, 128, 4, 128, -2.0),
    (1, 100, 1, 64, -2.0),     # B*H = 1: the plan's narrowest CTAs
    (2, 100, 8, 128, -2.0),    # head dim 128 at the prefill length
    (2, 37, 4, 64, -2.0),      # T not a multiple of the chunk
    (4, 100, 32, 64, 2.0),     # decays near 0
    (4, 100, 32, 64, -6.0),    # decays near 1
])
def test_wkv6_kernel_matches_plain(cuda, b, t, h, hd, log_decay):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda)
                         for a in _wkv_inputs(b, t, h, hd, log_decay=log_decay))
    n = wkv.launches
    o, s = wkv.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv.launches == n + 1
    want_o, want_s = wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, want_o, atol=GPU_F32_TOL, rtol=GPU_F32_TOL)
    torch.testing.assert_close(s, want_s, atol=GPU_F32_TOL, rtol=GPU_F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 100])
def test_wkv6_kernel_in_place_equals_a_separate_state(cuda, t):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(4, t, 8, 64))
    o_sep, s_sep = wkv.wkv6(r, k, v, w, u, s0)
    state = s0.clone()
    o_in, s_in = wkv.wkv6(r, k, v, w, u, state, out_state=state)
    torch.cuda.synchronize()
    assert s_in is state
    assert torch.equal(o_in, o_sep) and torch.equal(state, s_sep)


@pytest.mark.gpu
def test_wkv6_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, 4, 2, 48))
    with pytest.raises(ValueError, match="head dim"):
        wkv.wkv6(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, 4, 2, 32))
    with pytest.raises(ValueError, match="float32"):
        wkv.wkv6(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6(r.transpose(1, 2), k, v, w, u, s0)
    shifted = torch.empty(r.numel() + 1, device=cuda)[1:].view(r.shape).copy_(r)
    with pytest.raises(ValueError, match="aligned"):
        wkv.wkv6(shifted, k, v, w, u, s0)


# ----------------------------------------------------------------------
# on the card: the backward kernels (K1-bwd, K3-bwd) against their plain
# versions, and the autograd Functions through them
# ----------------------------------------------------------------------

def _rel_max(got, want):
    """Max abs error relative to the largest magnitude of ``want``."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kh,hd,window", [
    (2, 512, 8, 8, 128, 0),     # deepseek's training shape, fewer heads
    (2, 256, 6, 2, 64, 0),      # GQA 3:1 at head dim 64 (granite's ratio)
    (1, 300, 4, 1, 128, 0),     # MQA, ragged S
    (1, 256, 4, 4, 128, 64),    # window
    (2, 70, 4, 4, 32, 0),       # head dim 32, ragged
    (2, 333, 4, 2, 32, 100),    # ragged, window across tiles
    (1, 300, 8, 2, 128, 100),   # head dim 128, ragged, a window of no whole tiles
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, GPU_F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, s, h, kh, hd, window, dtype, tol):
    from repro_torch.kernels.attention import flash_bwd
    from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                                   flash_attention_fwd_ref)
    q = _dev(_rand((b, s, h, hd), 1), dtype, cuda)
    k = _dev(_rand((b, s, kh, hd), 2), dtype, cuda)
    v = _dev(_rand((b, s, kh, hd), 3), dtype, cuda)
    do = _dev(_rand((b, s, h, hd), 4), dtype, cuda)
    o, lse = flash.flash_attention(q, k, v, window=window, with_lse=True)
    _, want_lse = flash_attention_fwd_ref(q, k, v, window=window)
    assert _rel_max(lse, want_lse) < GPU_F32_TOL
    n = flash_bwd.launches
    got = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    again = flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    assert flash_bwd.launches == n + 2
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, window=window)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)          # two passes, no atomics: bit-equal runs
        assert _rel_max(g, w) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,hd,log_decay", [
    (2, 512, 8, 64, -2.0),     # rwkv6's training shape, fewer heads
    (2, 37, 4, 64, -2.0),      # T not a multiple of the chunk
    (2, 100, 4, 64, 2.0),      # decays near 0
    (2, 100, 4, 64, -6.0),     # decays near 1
    (1, 50, 2, 128, -2.0),
    (2, 40, 2, 32, -2.0),
    (1, 33, 1, 16, -2.0),
    (4, 40, 32, 64, -2.0),     # 128 heads, as in the train step
    (1, 16, 2, 32, -2.0),      # one whole chunk
    (2, 1, 2, 64, -2.0),       # one step
])
def test_wkv6_bwd_kernel_matches_plain(cuda, b, t, h, hd, log_decay):
    from repro_torch.kernels.rwkv import wkv_bwd
    from repro_torch.kernels.rwkv.ref import wkv6_bwd_ref
    ins = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(b, t, h, hd, log_decay=log_decay)]
    do = torch.from_numpy(_rand((b, t, h, hd), 9)).to(cuda)
    ds_t = torch.from_numpy(_rand((b, h, hd, hd), 10)).to(cuda)
    n = wkv_bwd.launches
    got = wkv_bwd.wkv6_bwd(*ins, do, ds_t)
    again = wkv_bwd.wkv6_bwd(*ins, do, ds_t)
    torch.cuda.synchronize()
    assert wkv_bwd.launches == n + 2
    want = wkv6_bwd_ref(*ins, do, ds_t)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _rel_max(g, w) < GPU_F32_TOL


@pytest.mark.gpu
def test_autograd_functions_launch_the_backward_kernels(cuda):
    from repro_torch.kernels.attention import flash_bwd
    from repro_torch.kernels.rwkv import wkv_bwd
    q = _dev(_rand((2, 128, 4, 64), 1), torch.float32, cuda).requires_grad_()
    k = _dev(_rand((2, 128, 2, 64), 2), torch.float32, cuda).requires_grad_()
    v = _dev(_rand((2, 128, 2, 64), 3), torch.float32, cuda).requires_grad_()
    do = _dev(_rand((2, 128, 4, 64), 4), torch.float32, cuda)
    n = (flash.launches, flash_bwd.launches)
    got = torch.autograd.grad(dispatch.flash_attention(q, k, v), (q, k, v), do)
    assert (flash.launches, flash_bwd.launches) == (n[0] + 1, n[1] + 1)
    want = torch.autograd.grad(flash_attention_ref(q, k, v), (q, k, v), do)
    for g, w in zip(got, want):
        assert _rel_max(g, w) < GPU_F32_TOL
    ins = [torch.from_numpy(a).to(cuda).requires_grad_() for a in _wkv_inputs(2, 40, 2, 64)]
    do = torch.from_numpy(_rand((2, 40, 2, 64), 9)).to(cuda)
    n = (wkv.launches, wkv_bwd.launches)
    o, _ = dispatch.rwkv_scan(*ins)
    got = torch.autograd.grad(o, ins, do)
    assert (wkv.launches, wkv_bwd.launches) == (n[0] + 1, n[1] + 1)
    want = torch.autograd.grad(wkv6_ref(*ins)[0], ins, do)
    for g, w in zip(got, want):
        assert _rel_max(g, w) < GPU_F32_TOL
    with pytest.raises(RuntimeError, match="requires grad"):
        flash.flash_attention(q, k, v)
