"""The block-join kernel's plain versions against the JAX package's Pallas
kernels (interpret mode), bit for bit, and the wrapper's checks.  The CUDA
kernel itself is held against the plain versions on the card in
``test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flat_join, reducer_join
from repro_torch.kernels import block_join as bj  # the module


@pytest.mark.parametrize(
    "k,cap_r,cap_s,c",
    [(1, 8, 8, 1), (4, 32, 16, 1), (3, 64, 64, 2), (8, 128, 32, 3), (2, 37, 5, 2),
     (3, 40, 30, 9), (2, 33, 50, 12)],
)
def test_block_join_matches_pallas(k, cap_r, cap_s, c):
    rng = np.random.default_rng(k * 100 + cap_r + c)
    rk = rng.integers(0, 10, size=(k, cap_r, c)).astype(np.int32)
    sk = rng.integers(0, 10, size=(k, cap_s, c)).astype(np.int32)
    rw = rng.integers(0, 5, size=(k, cap_r)).astype(np.int32)  # 0s = invalid
    sw = rng.integers(0, 5, size=(k, cap_s)).astype(np.int32)
    want_cnt, want_chk = reducer_join(*map(jnp.asarray, (rk, rw, sk, sw)))
    got_cnt, got_chk = bj.reducer_join(*map(torch.from_numpy, (rk, rw, sk, sw)))
    assert got_cnt.dtype == got_chk.dtype == torch.int32
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_chk.numpy(), np.asarray(want_chk))


def test_block_join_negative_weights_are_invalid():
    rk = np.zeros((1, 4, 1), np.int32)
    rw = np.array([[3, -2, 0, 1]], np.int32)
    sw = np.array([[-7, 5, 2, 0]], np.int32)
    want_cnt, want_chk = reducer_join(*map(jnp.asarray, (rk, rw, rk, sw)))
    got_cnt, got_chk = bj.reducer_join(*map(torch.from_numpy, (rk, rw, rk, sw)))
    assert int(got_cnt[0]) == int(want_cnt[0]) == 4
    assert int(got_chk[0]) == int(want_chk[0]) == (3 + 1) * (5 + 2)


@pytest.mark.parametrize("n,m,bn,bm", [(100, 50, 32, 32), (513, 257, 128, 64), (1, 1, 8, 8)])
def test_tiled_join_matches_pallas(n, m, bn, bm):
    rng = np.random.default_rng(n + m)
    rk = rng.integers(0, 20, size=(n, 1)).astype(np.int32)
    sk = rng.integers(0, 20, size=(m, 1)).astype(np.int32)
    rw = rng.integers(1, 7, size=n).astype(np.int32)
    sw = rng.integers(1, 7, size=m).astype(np.int32)
    want_cnt, want_chk = flat_join(*map(jnp.asarray, (rk, rw, sk, sw)), block_n=bn, block_m=bm)
    got_cnt, got_chk = bj.flat_join(*map(torch.from_numpy, (rk, rw, sk, sw)))
    assert int(got_cnt) == int(want_cnt)
    assert int(got_chk) == int(want_chk)


def test_tiled_join_wraparound_checksum():
    n = 256
    rk = np.zeros((n, 1), np.int32)
    rw = np.full(n, 40_000, np.int32)
    _, want = flat_join(*map(jnp.asarray, (rk, rw, rk, rw)))
    _, got = bj.flat_join(*map(torch.from_numpy, (rk, rw, rk, rw)))
    expect = (40_000 * 40_000 * n * n) % (1 << 32)
    assert int(np.uint32(np.int32(got))) == int(np.uint32(want)) == expect


def test_block_join_ref_slices_large_shapes():
    """The plain version walks reducers and R rows in slices; the result
    does not depend on the slice size."""
    rng = np.random.default_rng(3)
    rk = torch.from_numpy(rng.integers(0, 4, (5, 300, 2)).astype(np.int32))
    sk = torch.from_numpy(rng.integers(0, 4, (5, 200, 2)).astype(np.int32))
    rw = torch.from_numpy(rng.integers(0, 1 << 31, (5, 300)).astype(np.int32))
    sw = torch.from_numpy(rng.integers(0, 1 << 31, (5, 200)).astype(np.int32))
    whole = bj.block_join_ref(rk, rw, sk, sw)
    old = bj._REF_CHUNK
    try:
        bj._REF_CHUNK = 1000  # one reducer, five R rows per step
        sliced = bj.block_join_ref(rk, rw, sk, sw)
    finally:
        bj._REF_CHUNK = old
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
    want = reducer_join(*(jnp.asarray(t.numpy()) for t in (rk, rw, sk, sw)))
    for a, b in zip(whole, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("c", [1, 2, 3, 8, 9, 12, 100, 9000])
@pytest.mark.parametrize("cap_r", [1, 37, 3008, 1 << 20])
def test_chunk_geometry(cap_r, c):
    """A block's hash table is a power of two above its chunk, table and
    staged rows fit the shared memory a block aims for, and the chunk is
    all of cap_r where that fits (the §9.1 bins: one block a reducer)."""
    chunk, slots = bj.chunk_geometry(cap_r, c)
    assert 1 <= chunk <= cap_r and slots > chunk and slots & (slots - 1) == 0
    assert slots <= 2 * chunk + 1 or chunk == 1
    assert 12 * slots + 4 * (c + 1) * chunk <= bj._SMEM
    if (cap_r, c) == (3008, 1):
        assert (chunk, slots) == (3008, 4096)
    if chunk < cap_r:  # one row more would not fit
        assert 12 * (1 << (chunk + 1).bit_length()) + 4 * (c + 1) * (chunk + 1) > bj._SMEM
    assert bj.chunk_geometry(cap_r, c + 1)[0] <= chunk


def test_chunk_geometry_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        bj.chunk_geometry(10, 20_000)


def _aggregate_join(rk, rw, sk, sw):
    """The kernel's algorithm in numpy: per reducer and R chunk of
    chunk_geometry, the valid R rows aggregated by key into (count, weight
    sum), each valid S row probing once; sums mod 2^32."""
    k, cap_r, c = rk.shape
    chunk, _ = bj.chunk_geometry(cap_r, c)
    cnt = np.zeros(k, np.int64)
    chk = np.zeros(k, np.int64)
    for r in range(k):
        for r0 in range(0, cap_r, chunk):
            table = {}
            for key, w in zip(map(tuple, rk[r, r0:r0 + chunk]), rw[r, r0:r0 + chunk]):
                if w > 0:
                    n_, s_ = table.get(key, (0, 0))
                    table[key] = (n_ + 1, (s_ + int(w)) & 0xFFFFFFFF)
            for key, w in zip(map(tuple, sk[r]), sw[r]):
                if w > 0 and key in table:
                    cnt[r] += table[key][0]
                    chk[r] = (chk[r] + table[key][1] * int(w)) & 0xFFFFFFFF
    return cnt.astype(np.int32), np.where(chk >= 1 << 31, chk - (1 << 32), chk).astype(np.int32)


@pytest.mark.parametrize("k,cap_r,cap_s,c", [(3, 3100, 40, 1), (2, 1500, 30, 9), (4, 60, 70, 2)])
def test_aggregate_by_key_equals_the_pairwise_join(k, cap_r, cap_s, c):
    """count = sum_v n_R(v) n_S(v) and checksum = sum_v W_R(v) W_S(v) mod
    2^32, summed over the kernel's R chunks, equal the pairwise plain
    version: the identities the kernel's hash join rests on."""
    rng = np.random.default_rng(k + cap_r + c)
    rk = rng.integers(-3, 4, (k, cap_r, c)).astype(np.int32)
    sk = rng.integers(-3, 4, (k, cap_s, c)).astype(np.int32)
    rk[0, :, :] = 2  # a heavy hitter: one key for every row of reducer 0
    rw = rng.integers(-1, 1 << 31, (k, cap_r)).astype(np.int32)
    sw = rng.integers(-1, 1 << 31, (k, cap_s)).astype(np.int32)
    want = bj.block_join_ref(*map(torch.from_numpy, (rk, rw, sk, sw)))
    got = _aggregate_join(rk, rw, sk, sw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_wrapper_rejects_bad_operands():
    z = torch.zeros
    ok = (z((2, 4, 1), dtype=torch.int32), z((2, 4), dtype=torch.int32),
          z((2, 3, 1), dtype=torch.int32), z((2, 3), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        bj.reducer_join(ok[0].long(), *ok[1:])
    with pytest.raises(ValueError, match="contiguous"):
        bj.reducer_join(z((2, 8, 1), dtype=torch.int32)[:, ::2], *ok[1:])
    with pytest.raises(ValueError, match="shapes differ"):
        bj.reducer_join(ok[0], ok[1], z((3, 3, 1), dtype=torch.int32), ok[3])
    with pytest.raises(ValueError, match="weights"):
        bj.reducer_join(ok[0], z((2, 5), dtype=torch.int32), ok[2], ok[3])
    big = torch.empty((1, 1 << 16, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        bj.reducer_join(big, torch.empty((1, 1 << 16), dtype=torch.int32), big,
                      torch.empty((1, 1 << 16), dtype=torch.int32))
    # the CPU path is the plain version and never counts a kernel launch
    bj.reset_launches()
    bj.reducer_join(*ok)
    bj.flat_join(ok[0][0], ok[1][0], ok[2][0], ok[3][0])
    assert bj.LAUNCHES == {"reducer_join": 0, "flat_join": 0}
