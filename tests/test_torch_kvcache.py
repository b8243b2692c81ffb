"""The port's KV-cache utilities (``serving/kvcache.py``) against the
reference's ``repro.serving.kvcache``, operation for operation, on the CPU:
the same allocations, releases and writes give the same block tables, free
lists, pool contents and gathers, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.serving import kvcache as ref_kvcache
from repro_torch.configs import deepseek_7b
from repro_torch.serving import kvcache

REF_CFG = ARCHS["deepseek-7b"].smoke
CFG = deepseek_7b.SMOKE
L, KH, HD = CFG.num_layers, CFG.num_kv_heads, CFG.resolved_head_dim


def _pools(n_blocks=8, block=4, dtype="float32"):
    return (ref_kvcache.PagedPool(REF_CFG, n_blocks=n_blocks, block=block, dtype=dtype),
            kvcache.PagedPool(CFG, n_blocks=n_blocks, block=block, dtype=dtype, device="cpu"))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same_pool(ref, pool):
    assert pool.free == ref.free and pool.tables == ref.tables
    assert pool.lengths == ref.lengths and pool.utilization == ref.utilization
    np.testing.assert_array_equal(pool.k.float().numpy(), np.asarray(ref.k, np.float32))
    np.testing.assert_array_equal(pool.v.float().numpy(), np.asarray(ref.v, np.float32))


def _both(ref, pool, method, *args):
    """Call ``method`` on both pools with the same numpy arguments; the
    outcomes (a value or the exception's type) must agree."""
    out = []
    for p, conv in ((ref, jnp.asarray), (pool, torch.from_numpy)):
        a = [conv(x) if isinstance(x, np.ndarray) else x for x in args]
        try:
            out.append(getattr(p, method)(*a))
        except MemoryError as e:
            out.append(type(e))
    assert out[0] == out[1]
    return out[1]


# ----------------------------------------------------------------------
# allocation, held host-side
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_allocation_sequence_equals_the_reference(seed):
    """A random run of allocate / extend / release, exhaustion included."""
    rng = np.random.default_rng(seed)
    ref, pool = _pools(n_blocks=16, block=4)
    live = []
    for step in range(40):
        op = rng.integers(0, 3)
        if op == 0 or not live:
            _both(ref, pool, "allocate", step, int(rng.integers(1, 20)))
            if step in ref.tables:
                live.append(step)
        elif op == 1:
            _both(ref, pool, "extend", live[int(rng.integers(len(live)))], int(rng.integers(1, 6)))
        else:
            _both(ref, pool, "release", live.pop(int(rng.integers(len(live)))))
        _same_pool(ref, pool)
        held = [b for t in pool.tables.values() for b in t]
        assert len(held) == len(set(held)) and len(held) + len(pool.free) == 16


def test_pool_exhaustion_raises_as_the_reference():
    ref, pool = _pools(n_blocks=2, block=4)
    _both(ref, pool, "allocate", 1, 8)
    assert _both(ref, pool, "allocate", 2, 1) is MemoryError
    assert _both(ref, pool, "extend", 1, 1) is MemoryError


# ----------------------------------------------------------------------
# device data movement
# ----------------------------------------------------------------------

@pytest.mark.parametrize("allocated,written", [(10, 10), (8, 8), (5, 10), (3, 1)])
def test_write_prefill_and_gather_equal_the_reference(allocated, written):
    """One indexed copy over the block table: a ragged last block zero-padded,
    more tokens than the allocated blocks cut, as the reference does."""
    ref, pool = _pools()
    _both(ref, pool, "allocate", 0, 6)             # another sequence's blocks first
    _both(ref, pool, "write_prefill", 0, _rand((L, 6, KH, HD), 1), _rand((L, 6, KH, HD), 2))
    _both(ref, pool, "allocate", 7, allocated)
    ks, vs = _rand((L, written, KH, HD), 3), _rand((L, written, KH, HD), 4)
    _both(ref, pool, "write_prefill", 7, ks, vs)
    _same_pool(ref, pool)
    for pad_to in (None, 16):
        want = ref.gather(7, pad_to)
        got = pool.gather(7, pad_to)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_token_lands_where_the_reference_writes_it():
    ref, pool = _pools()
    _both(ref, pool, "allocate", 3, 5)
    _both(ref, pool, "write_prefill", 3, _rand((L, 5, KH, HD), 5), _rand((L, 5, KH, HD), 6))
    for i in range(6):                       # across the block boundary at 8
        _both(ref, pool, "extend", 3)
        _both(ref, pool, "write_token", 3, _rand((L, KH, HD), 10 + i), _rand((L, KH, HD), 20 + i))
        _same_pool(ref, pool)
    gk, gv, mask = pool.gather(3)
    assert int(mask.sum()) == 11
    np.testing.assert_array_equal(gk[:, 10].numpy(), _rand((L, KH, HD), 15))


def test_bfloat16_pool_rounds_as_the_reference():
    ref, pool = _pools(dtype="bfloat16")
    assert pool.k.dtype == torch.bfloat16
    _both(ref, pool, "allocate", 0, 7)
    _both(ref, pool, "write_prefill", 0, _rand((L, 7, KH, HD), 7), _rand((L, 7, KH, HD), 8))
    _same_pool(ref, pool)


# ----------------------------------------------------------------------
# the linear and windowed views
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 3, 7, 9])     # 9: past the cache, clamped as the reference
@pytest.mark.parametrize("as_tensor", [False, True])
def test_append_equals_the_reference(pos, as_tensor):
    cache = {n: _rand((L, 2, 8, KH, HD), i) for i, n in enumerate(("k", "v"))}
    k1, v1 = _rand((L, 2, 1, KH, HD), 5), _rand((L, 2, 1, KH, HD), 6)
    want = ref_kvcache.append({n: jnp.asarray(a) for n, a in cache.items()},
                              jnp.asarray(k1), jnp.asarray(v1), jnp.int32(pos))
    mine = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got = kvcache.append(mine, torch.from_numpy(k1), torch.from_numpy(v1),
                         torch.tensor(pos) if as_tensor else pos)
    assert got is mine
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("seq,pos,window", [(8, 5, 3), (8, 5, 0), (12, 0, 4), (12, 11, 20),
                                            (6, 9, 2)])
def test_valid_mask_equals_the_reference(seq, pos, window):
    want = np.asarray(ref_kvcache.valid_mask(seq, jnp.int32(pos), window))
    np.testing.assert_array_equal(kvcache.valid_mask(seq, pos, window, device="cpu").numpy(),
                                  want)
    np.testing.assert_array_equal(kvcache.valid_mask(seq, torch.tensor(pos), window).numpy(),
                                  want)
