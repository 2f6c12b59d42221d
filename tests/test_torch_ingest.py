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
