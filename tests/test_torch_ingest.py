"""The torch port's fused ingest pass (K2, K3) and Count-Min update (K4)
against the JAX package's, bit for bit: the plain versions and the CPU
route through the wrappers, on plans with heavy-hitter pins and
ordinary-type excludes, at edge sizes and edge values.  The CUDA kernels
themselves are held against these plain versions in
``tests/test_torch_gpu.py`` on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import ingest_fused as jfused
from repro.kernels import ref as jref
from repro.mapreduce.hashing import bucket_np
from repro.mapreduce.keys import static_route_table
from repro_torch.kernels import ingest_fused as tfused
from repro_torch.kernels import sketch_update as tsketch
from torch_cases import wide_routes

_I32 = np.iinfo(np.int32)
_SEEDS = (11, 222, (1 << 31) + 5, (1 << 32) - 1)


def _skewed_plan(query, seed, q=60):
    """A plan with pinned heavy hitters, so pins and excludes are routed."""
    rng = np.random.default_rng(seed)
    data = {
        r.name: rng.integers(0, 50, size=(600, r.arity)).astype(np.int64)
        for r in query.relations
    }
    for r in query.relations:
        data[r.name][:300, -1] = 7
    plan = jcore.plan_shares_skew(query, data, q=q)
    assert plan.hh_values
    return plan


def _rows(n, arity, seed, extremes=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 60, size=(n, arity)).astype(np.int32)
    if extremes and n >= 4:
        rows[-1] = _I32.min
        rows[-2] = _I32.max
        rows[-3, 0] = 7  # a heavy hitter in the first column
    return rows


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, np.asarray(w))


_QUERIES = {"2way": jcore.two_way, "3way": jcore.three_way_paper}


@pytest.mark.parametrize("name", sorted(_QUERIES))
@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_fused_ingest_matches_jax_ref(name, n):
    query = _QUERIES[name]()
    plan = _skewed_plan(query, seed=n + len(name))
    for rel in query.relations:
        routes = static_route_table(plan, rel)
        rows = _rows(n, rel.arity, seed=n)
        kw = dict(routes=routes, sketch_cols=(rel.arity - 1,), seeds=_SEEDS,
                  width=128, num_reducers=plan.total_reducers)
        want = jref.fused_ingest_ref(jnp.asarray(rows), **kw)
        t = torch.from_numpy(rows)
        _assert_same(tfused.fused_ingest_ref(t, **kw), want)
        _assert_same(tfused.fused_ingest(t, **kw), want)  # the CPU route


@pytest.mark.parametrize("mode", ["route", "sketch", "both"])
def test_static_modes_match_jax_ref(mode):
    query = jcore.two_way()
    plan = _skewed_plan(query, seed=3)
    rel = query.relations[1]
    routes = static_route_table(plan, rel) if mode != "sketch" else ()
    cols = (0, 1) if mode != "route" else ()
    rows = _rows(129, rel.arity, seed=4)
    kw = dict(routes=routes, sketch_cols=cols, seeds=_SEEDS, width=100,
              num_reducers=plan.total_reducers)
    want = jref.fused_ingest_ref(jnp.asarray(rows), **kw)
    got = tfused.fused_ingest(torch.from_numpy(rows), **kw)
    _assert_same(got, want)
    assert (got[0] is None) == (mode == "sketch")
    assert (got[3] is None) == (mode == "route")


def test_dense_matches_jax_dense_kernel_in_interpret_mode():
    """The dense wrapper's CPU route against ``fused_ingest_dense_pallas``
    run in Pallas interpret mode, at a tiny N."""
    query = jcore.two_way()
    plan = _skewed_plan(query, seed=5)
    k_pad = -(-plan.total_reducers // 128) * 128
    for rel in query.relations:
        routes = static_route_table(plan, rel)
        w = jfused.route_width(routes)
        wp = 1 << max(0, (w - 1).bit_length())
        enc = jfused.dense_route_encoding(routes, rel.arity, wp, max_values=8)
        rows = _rows(9, rel.arity, seed=6)
        d, r, c, m = jfused.fused_ingest_dense_pallas(
            jnp.asarray(rows), enc, sketch_cols=(1,), seeds=_SEEDS, width=64,
            k_pad=k_pad, block=128, double_buffer=False, interpret=True,
        )
        got = tfused.fused_ingest_dense(
            torch.from_numpy(rows), enc, sketch_cols=(1,), seeds=_SEEDS,
            width=64, k_pad=k_pad,
        )
        _assert_same(got, (np.asarray(d)[:9], np.asarray(r)[:9], c, m))


@pytest.mark.parametrize("name", sorted(_QUERIES))
def test_dense_equals_static_with_padding(name):
    """Padded columns (Wp > W) and a padded exclude list (V = the
    planner's cap) change nothing in the real columns."""
    query = _QUERIES[name]()
    plan = _skewed_plan(query, seed=7)
    k = plan.total_reducers
    for rel in query.relations:
        routes = static_route_table(plan, rel)
        w = tfused.route_width(routes)
        enc = tfused.dense_route_encoding(routes, rel.arity, 2 * w, max_values=8)
        t = torch.from_numpy(_rows(257, rel.arity, seed=8))
        d, r, c, _ = tfused.fused_ingest_dense(t, enc, k_pad=-(-k // 128) * 128 + 128)
        want = tfused.fused_ingest(t, routes=routes, num_reducers=k)
        assert (d[:, w:] == -1).all() and (r[:, w:] == -1).all()
        _assert_same((d[:, :w], r[:, :w], c[:k]), want[:3])
        assert int(c[k:].sum()) == 0


def _brute_rank(dest):
    seen, rank = {}, np.full(dest.shape, -1, np.int32)
    for i, j in np.ndindex(dest.shape):
        d = int(dest[i, j])
        if d >= 0:
            rank[i, j] = seen.get(d, 0)
            seen[d] = rank[i, j] + 1
    return rank


def test_dense_rank_is_flat_row_major_order_with_repeated_destinations():
    """Hand-made encodings whose columns collide (the same destination
    twice in one row, and across rows): rank counts earlier emissions in
    flat row-major order, and counts is the destination histogram."""
    rng = np.random.default_rng(9)
    wp, arity = 8, 3
    enc = tfused.dense_route_encoding((), arity, wp, max_values=2)
    enc["col_valid"][:7] = 1
    enc["col_base"][:] = [0, 0, 3, 5, 5, 1, 2, 9]
    enc["h_col"][:, 0] = rng.integers(0, arity, wp)
    enc["h_seed"][:, 0] = rng.integers(_I32.min, _I32.max, wp)
    enc["h_dim"][:, 0] = [2, 3, 1, 4, 4, 2, 1, 1]
    enc["h_stride"][:, 0] = [1, 1, 0, 2, 2, 3, 0, 0]
    enc["p_col"][3, 0], enc["p_val"][3, 0], enc["p_on"][3, 0] = 1, 2, 1
    enc["e_col"][5, 1] = 2
    enc["e_val"][5, 1] = [0, 4]
    enc["e_on"][5, 1] = [1, 1]
    rows = rng.integers(0, 5, size=(301, arity)).astype(np.int32)
    d, r, c, _ = tfused.fused_ingest_dense(torch.from_numpy(rows), enc, k_pad=128)
    jd, jr, jc, _ = jfused.fused_ingest_dense_pallas(
        jnp.asarray(rows), enc, k_pad=128, block=64, double_buffer=False, interpret=True,
    )
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd)[:301])
    np.testing.assert_array_equal(r.numpy(), _brute_rank(d.numpy()))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr)[:301])
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        c.numpy(), np.bincount(d.numpy()[d.numpy() >= 0], minlength=128)
    )
    assert (d[:, 7] == -1).all()  # padded column
    # some row sends two emissions to one reducer
    assert any(len(set(x[x >= 0].tolist())) < int((x >= 0).sum()) for x in d.numpy())


@pytest.mark.parametrize("name", sorted(_QUERIES))
def test_dense_route_encoding_matches_jax(name):
    query = _QUERIES[name]()
    plan = _skewed_plan(query, seed=10)
    for rel in query.relations:
        routes = static_route_table(plan, rel)
        w = jfused.route_width(routes)
        assert tfused.route_width(routes) == w
        for wp, mv in ((w, 8), (1 << max(0, (w - 1).bit_length()), 3), (w + 5, 1)):
            if mv < max((len(v) for *_, ex in routes for _, v in ex), default=0):
                with pytest.raises(ValueError):
                    tfused.dense_route_encoding(routes, rel.arity, wp, mv)
                with pytest.raises(ValueError):
                    jfused.dense_route_encoding(routes, rel.arity, wp, mv)
                continue
            got = tfused.dense_route_encoding(routes, rel.arity, wp, mv)
            want = jfused.dense_route_encoding(routes, rel.arity, wp, mv)
            assert list(got) == list(want) == list(tfused._ENC_KEYS)
            for key in tfused._ENC_KEYS:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("k", [131_075, 1_048_576])
def test_many_reducers_match_jax_ref(k):
    """More reducers than the first CUDA kernels could count (114,688): the
    plain versions and the CPU route against the JAX package's oracle."""
    routes = wide_routes(k)
    rows = _rows(301, 2, seed=k)
    rows[:50, 0] = 7  # the pin holds on these
    kw = dict(routes=routes, sketch_cols=(1,), seeds=_SEEDS, width=64, num_reducers=k)
    want = jref.fused_ingest_ref(jnp.asarray(rows), **kw)
    t = torch.from_numpy(rows)
    _assert_same(tfused.fused_ingest_ref(t, **kw), want)
    _assert_same(tfused.fused_ingest(t, **kw), want)
    assert int(np.asarray(want[0]).max()) == k - 1
    enc = tfused.dense_route_encoding(routes, 2, tfused.route_width(routes), max_values=2)
    got = tfused.fused_ingest_dense(t, enc, sketch_cols=(1,), seeds=_SEEDS, width=64, k_pad=k)
    _assert_same(got, want)


def _mix32(x, seed):
    x = (x ^ np.uint64(seed)) & np.uint64(_M32)
    x = ((x ^ (x >> np.uint64(16))) * np.uint64(0x7FEB352D)) & np.uint64(_M32)
    x = ((x ^ (x >> np.uint64(15))) * np.uint64(0x846CA68B)) & np.uint64(_M32)
    return x ^ (x >> np.uint64(16))


_M32 = 0xFFFFFFFF


def _run_program(prog, rows, wp):
    """The count kernel's evaluation of a route program, group by group, in
    numpy: the destinations it gives."""
    words = prog.reshape(-1, 4).astype(np.int64)
    uwords = prog.view(np.uint32).reshape(-1, 4).astype(np.uint64)
    n_g, width, bases_at, owners_at = words[0]
    assert width == wp
    bases = prog.view(np.uint32)[4 * bases_at:4 * bases_at + wp].astype(np.uint64)
    owners = prog[4 * owners_at:4 * owners_at + wp]
    r = rows.astype(np.int64)
    out = np.full((rows.shape[0], wp), -7, np.int64)
    for g in range(n_g):
        first, count, tests, hashed = words[1 + 2 * g]
        assert (owners[first:first + count] == g).all()
        if tests < 0:
            out[:, first:first + count] = -1
            continue
        at = words[2 + 2 * g][0]
        ok = np.ones(rows.shape[0], bool)
        for col, value, must_equal, _ in words[at:at + tests]:
            ok &= (r[:, col] == value) == bool(must_equal)
        acc = np.zeros(rows.shape[0], np.uint64)
        for j in range(hashed):
            col, seed, dim, stride = uwords[at + tests + 2 * j]
            magic, shift = uwords[at + tests + 2 * j + 1][:2]
            x = _mix32(r[:, int(col)].astype(np.uint64) & np.uint64(_M32), seed)
            hi = (x * magic) >> np.uint64(32)
            q = (hi + ((x - hi) >> np.uint64(1))) >> shift
            acc = (acc + (x - q * dim) * stride) & np.uint64(_M32)
        for c in range(first, first + count):
            d = ((acc + bases[c]) & np.uint64(_M32)).astype(np.int64)
            out[:, c] = np.where(ok, np.where(d >= 1 << 31, d - (1 << 32), d), -1)
    assert (out != -7).all()
    return out


def _repeated_destinations_enc(seed, k_pad=128):
    rng = np.random.default_rng(seed)
    enc = tfused.dense_route_encoding((), 3, 8, max_values=2)
    enc["col_valid"][:7] = 1
    enc["col_base"][:] = [0, 0, 3, 5, 5, 1, 2, 9]
    enc["col_base"][:7] += k_pad - 20
    enc["h_col"][:, 0] = rng.integers(0, 3, 8)
    enc["h_seed"][:, 0] = rng.integers(_I32.min, _I32.max, 8)
    enc["h_dim"][:, 0] = [2, 3, 1, 4, 4, 2, 1, 1]
    enc["h_stride"][:, 0] = [1, 1, 0, 2, 2, 3, 0, 0]
    enc["p_col"][3, 0], enc["p_val"][3, 0], enc["p_on"][3, 0] = 1, 2, 1
    enc["e_col"][5, 1], enc["e_val"][5, 1], enc["e_on"][5, 1] = 2, [0, 4], [1, 1]
    return enc


@pytest.mark.parametrize("name", ["2way", "3way", "repeated", "wide"])
def test_route_program_gives_the_encodings_destinations(name):
    """The program the kernels read, evaluated group by group as the count
    kernel does, against the dense encoding's plain destinations: pins,
    excludes, padded columns, replicas sharing their terms and hashed
    dimensions of every size, at extreme row values."""
    if name in _QUERIES:
        query = _QUERIES[name]()
        plan = _skewed_plan(query, seed=18)
        cases = [(static_route_table(plan, rel), rel.arity) for rel in query.relations]
        encs = [tfused.dense_route_encoding(r, a, tfused.route_width(r) + 3, 8)
                for r, a in cases]
    elif name == "repeated":
        encs = [_repeated_destinations_enc(19)]
    else:
        routes = wide_routes(1_048_576)
        encs = [tfused.dense_route_encoding(routes, 2, tfused.route_width(routes), 2)]
    for enc in encs:
        arity = 1 + max(int(np.max(enc[k])) for k in ("h_col", "p_col", "e_col"))
        rows = _rows(2000, max(arity, 2), seed=20)
        rows[:40, 0] = 7
        want = tfused._dense_dest_ref(torch.from_numpy(rows), tfused._enc_tensors(enc, "cpu"))
        prog = tfused.route_program(enc)
        assert prog.dtype == np.int32 and prog.size % 4 == 0
        got = _run_program(prog, rows, enc["col_base"].shape[0])
        np.testing.assert_array_equal(got, want.numpy())
        assert (got >= 0).any()
        groups = int(prog[0])
        assert groups < enc["col_base"].shape[0] or name == "repeated"


def test_divisor_magic_divides_exactly():
    """The kernels' x // d by multiply-high and shifts equals the division
    for every tested 32-bit x and 2 <= d < 2^32."""
    rng = np.random.default_rng(21)
    ds = np.concatenate([np.arange(2, 1025), 1 << np.arange(1, 32),
                         rng.integers(2, 1 << 32, 500), [(1 << 31) - 1, (1 << 32) - 1]])
    xs = np.concatenate([rng.integers(0, 1 << 32, 4000), [0, 1, _M32, 1 << 31, (1 << 31) - 1]])
    xs = xs.astype(np.uint64)
    for d in ds.tolist():
        magic, shift = tfused.divisor_magic(d)
        assert 0 <= magic < 1 << 32 and 0 <= shift < 32
        edges = np.array([d - 1, d, d + 1, 2 * d - 1], np.uint64) & np.uint64(_M32)
        x = np.concatenate([xs, edges])
        hi = (x * np.uint64(magic)) >> np.uint64(32)
        q = (hi + ((x - hi) >> np.uint64(1))) >> np.uint64(shift)
        np.testing.assert_array_equal(q, x // np.uint64(d))
    for bad in (0, 1, 1 << 32):
        with pytest.raises(ValueError):
            tfused.divisor_magic(bad)


# csrc/ingest_fused.cu's limits (tile_limits() on the card): emissions and
# words of rows a tile
_TILE_LIMITS = (65_535, 8_192)


@pytest.mark.parametrize("n,wp,arity,k_pad,sms", [
    (100_000, 45, 2, 3_907, 132),  # the stream's R pass
    (100_000, 32, 2, 1_271, 132),
    (25_000, 85, 2, 3_907, 132),
    (50_001, 8, 3, 1_048_576, 132),
    (200_003, 8, 3, 1_048_576, 132),
    (1, 3, 3, 128, 132),
    (4_097, 1, 2, 131_075, 2),
    (1_000_000, 1, 40, 128, 132),  # wide rows: the staged words bind
    (10, 70_000, 2, 5, 132),
    (10, 2, 9_000, 5, 132),
])
def test_launch_geometry(n, wp, arity, k_pad, sms):
    """Tiles of at most max_tile emissions and max_row_words words of rows,
    about four an SM where the rows allow, none smaller than _MIN_TILE
    emissions unless the rows run out or a limit binds, and a count table
    of at most _TABLE_MAX entries unless a limit binds."""
    max_tile, max_row_words = _TILE_LIMITS
    if wp > max_tile or arity > max_row_words:
        with pytest.raises(ValueError, match="per tile"):
            tfused.launch_geometry(n, wp, arity, k_pad, sms, *_TILE_LIMITS)
        return
    rpt = tfused.launch_geometry(n, wp, arity, k_pad, sms, *_TILE_LIMITS)
    tiles = -(-n // rpt)
    bound = rpt == max_tile // wp or rpt == max_row_words // arity
    assert 1 <= rpt <= n and rpt * wp <= max_tile and rpt * arity <= max_row_words
    assert tiles * k_pad <= tfused._TABLE_MAX or bound
    assert rpt * wp >= tfused._MIN_TILE or rpt == n or bound
    if (n, wp, k_pad) == (100_000, 45, 3_907):
        assert (rpt, tiles) == (190, 527)  # 8,550 emissions a tile, ~4 an SM
    if k_pad < 100_000 and n * wp >= 4 * sms * tfused._MIN_TILE and not bound:
        assert tiles <= 4 * sms


def _emulate_rank_kernels(dest, k_pad, rpt, range_=12_288, warps=8):
    """csrc/ingest_fused.cu's count, scan and rank kernels in numpy, block by
    block: per (tile, range) the warps' segments, their counters' prefix
    and the walk in 32-lane steps."""
    n, wp = dest.shape
    flat = dest.reshape(-1).astype(np.int64)
    tiles = -(-n // rpt)
    table = np.zeros((tiles, k_pad), np.int64)
    for t in range(tiles):
        seg = flat[t * rpt * wp:min(n, (t + 1) * rpt) * wp]
        table[t] = np.bincount(seg[seg >= 0], minlength=k_pad)
    counts = table.sum(0)
    base = np.cumsum(table, 0) - table
    rank = np.full(flat.shape, -7, np.int64)
    for t, lo in np.ndindex(tiles, -(-k_pad // range_)):
        lo *= range_
        width = min(range_, k_pad - lo)
        off = t * rpt * wp
        e_n = (min(n, (t + 1) * rpt) - t * rpt) * wp
        step = -(-(-(-e_n // warps)) // 32) * 32
        keys = flat[off:off + e_n] - lo
        keys = np.where((flat[off:off + e_n] >= 0) & (keys >= 0) & (keys < width), keys, -1)
        wcnt = np.zeros((warps, width), np.int64)
        for w in range(warps):
            k = keys[w * step:(w + 1) * step]
            wcnt[w] = np.bincount(k[k >= 0], minlength=width)
        assert wcnt.sum(0).max(initial=0) <= 0xFFFF
        wcnt = np.cumsum(wcnt, 0) - wcnt
        for w in range(warps):
            for b in range(w * step, min(e_n, (w + 1) * step), 32):
                k = keys[b:min(e_n, (w + 1) * step, b + 32)]
                for lane, key in enumerate(k):
                    if key >= 0:
                        peers = int((k[:lane] == key).sum())
                        rank[off + b + lane] = base[t, lo + key] + wcnt[w, key] + peers
                    elif lo == 0 and flat[off + b + lane] < 0:
                        rank[off + b + lane] = -1
                for key in np.unique(k[k >= 0]):
                    wcnt[w, key] += int((k == key).sum())
    return rank.reshape(n, wp), counts


@pytest.mark.parametrize("n,wp,k_pad,range_,rpt", [
    (301, 8, 128, 12_288, None),  # one tile, one range
    (1_000, 7, 300, 64, None),  # five ranges
    (1_000, 7, 300, 64, 9),  # many tiles, ragged last tile
    (80, 45, 3_907, 1_000, 3),  # the stream's width
])
def test_rank_kernels_decomposition_gives_the_stable_rank(n, wp, k_pad, range_, rpt):
    """The kernels' split of the rank into tiles, destination ranges, warp
    segments and 32-lane steps gives the stable-sort rank and the counts."""
    rng = np.random.default_rng(n + wp)
    dest = rng.integers(0, min(k_pad, 40 if k_pad == 128 else k_pad), (n, wp))
    dest[rng.random((n, wp)) < 0.5] = -1
    rpt = rpt or tfused.launch_geometry(n, wp, 2, k_pad, 2, *_TILE_LIMITS)
    got_r, got_c = _emulate_rank_kernels(dest, k_pad, rpt, range_)
    want_r, want_c = tfused._rank_counts(torch.from_numpy(dest.astype(np.int32)), k_pad)
    np.testing.assert_array_equal(got_r, want_r.numpy())
    np.testing.assert_array_equal(got_c, want_c.numpy())


def test_k_pad_guard_raises():
    """A histogram narrower than the destination ids must raise: the TPU
    kernel would silently corrupt counts and ranks."""
    query = jcore.two_way()
    plan = _skewed_plan(query, seed=11, q=8)
    k = plan.total_reducers
    assert k > 128
    rel = query.relations[0]
    routes = static_route_table(plan, rel)
    w = tfused.route_width(routes)
    enc = tfused.dense_route_encoding(routes, rel.arity, w, max_values=8)
    t = torch.from_numpy(_rows(50, rel.arity, seed=12))
    with pytest.raises(ValueError, match="k_pad"):
        tfused.fused_ingest_dense(t, enc, k_pad=128)
    with pytest.raises(ValueError, match="k_pad"):
        tfused.fused_ingest_dense(t, enc, k_pad=0)
    with pytest.raises(ValueError, match="k_pad"):
        tfused.fused_ingest(t, routes=routes, num_reducers=k - 1)
    want = tfused.fused_ingest(t, routes=routes, num_reducers=k)
    # k_pad need not be a multiple of 128: the exact reducer count serves,
    # and so does the encoding checked and packed once
    _assert_same(tfused.fused_ingest_dense(t, enc, k_pad=k)[:3], want[:3])
    packed = tfused.pack_routes(enc, t.device)
    _assert_same(tfused.fused_ingest_dense(t, packed, k_pad=k)[:3], want[:3])
    with pytest.raises(ValueError, match="k_pad"):
        tfused.fused_ingest_dense(t, packed, k_pad=k - 1)


def test_wrappers_reject_bad_calls():
    t = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="routes and/or sketch_cols"):
        tfused.fused_ingest(t)
    with pytest.raises(ValueError, match="seeds"):
        tfused.fused_ingest(t, sketch_cols=(0,))
    with pytest.raises(TypeError):
        tfused.fused_ingest(t.long(), sketch_cols=(0,), seeds=(1,))
    enc = tfused.dense_route_encoding(((0, ((5, 1, 4, 1),), (0,), (), ()),), 2, 1, 1)
    with pytest.raises(ValueError, match="column"):
        tfused.fused_ingest_dense(t, enc)
    with pytest.raises(ValueError, match="column"):
        tsketch.cms_tables(t, (2,), (1,), 8)


def test_width_one_routes():
    """W = 1: a single-reducer plan sends every row once, to reducer 0."""
    query = jcore.two_way()
    rng = np.random.default_rng(13)
    data = {r.name: rng.integers(0, 9, (20, 2)).astype(np.int64) for r in query.relations}
    plan = jcore.plan_shares_skew(query, data, q=1000)
    for rel in query.relations:
        routes = static_route_table(plan, rel)
        assert tfused.route_width(routes) == 1
        rows = _rows(33, rel.arity, seed=14)
        kw = dict(routes=routes, num_reducers=plan.total_reducers)
        want = jref.fused_ingest_ref(jnp.asarray(rows), **kw)
        got = tfused.fused_ingest(torch.from_numpy(rows), **kw)
        _assert_same(got, want)
        np.testing.assert_array_equal(got[1].numpy()[:, 0], np.arange(33))
        enc = tfused.dense_route_encoding(routes, rel.arity, 1, 8)
        dense = tfused.fused_ingest_dense(torch.from_numpy(rows), enc, k_pad=128)
        _assert_same((dense[0], dense[1], dense[2][: plan.total_reducers]), want[:3])


@pytest.mark.parametrize("width", [1, 7, 128, 251, 2048])
def test_cms_update_matches_reference_and_host_buckets(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(_I32.min, _I32.max, size=1000, dtype=np.int64, endpoint=True)
    vals[:3] = [_I32.min, _I32.max, -1]
    vals[3:300] = 42  # a heavy key
    vals = vals.astype(np.int32)
    want = np.asarray(jref.cms_update_ref(jnp.asarray(vals), _SEEDS, width))
    got = tsketch.cms_update(torch.from_numpy(vals), _SEEDS, width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    host = np.stack([np.bincount(bucket_np(vals, s, width), minlength=width) for s in _SEEDS])
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(tsketch.cms_update_ref(torch.from_numpy(vals), _SEEDS, width).numpy(), want)


def test_cms_update_empty_and_rejects_bad_input():
    z = tsketch.cms_update(torch.zeros(0, dtype=torch.int32), (1, 2), 16)
    assert z.shape == (2, 16) and int(z.abs().sum()) == 0
    with pytest.raises(ValueError, match="seed"):
        tsketch.cms_update(torch.zeros(3, dtype=torch.int32), (), 16)
    with pytest.raises(ValueError, match="width"):
        tsketch.cms_update(torch.zeros(3, dtype=torch.int32), (1,), 0)
    with pytest.raises(ValueError, match=r"\[N\]"):
        tsketch.cms_update(torch.zeros((3, 1), dtype=torch.int32), (1,), 4)


def test_plain_versions_never_dispatch_to_a_kernel(monkeypatch):
    """The plain versions are what the card's kernels are held against, so
    they must not reach the dispatching wrappers (which launch a kernel for
    a CUDA tensor)."""

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version called a dispatching wrapper")

    monkeypatch.setattr(tfused, "cms_tables", refuse)
    plan = _skewed_plan(jcore.two_way(), seed=16)
    rel = jcore.two_way().relations[0]
    routes = static_route_table(plan, rel)
    t = torch.from_numpy(_rows(40, rel.arity, seed=17))
    kw = dict(sketch_cols=(0, 1), seeds=_SEEDS, width=64)
    tfused.fused_ingest_ref(t, routes=routes, num_reducers=plan.total_reducers, **kw)
    enc = tfused.dense_route_encoding(routes, rel.arity, tfused.route_width(routes), 8)
    tfused.fused_ingest_dense_ref(t, enc, k_pad=-(-plan.total_reducers // 128) * 128, **kw)
