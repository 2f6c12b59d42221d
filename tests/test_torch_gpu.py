"""Card-only tests: the CUDA kernels against their plain versions, and the
port's join and stream engine on the card against their own CPU runs.  They carry the ``gpu``
marker and skip where no card is present; on a machine with one, run
``python -m pytest -m gpu tests/test_torch_gpu.py``.  This file imports no
JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch import mapreduce as tmr
from repro_torch import stream as tstream
from repro_torch.kernels import block_join as bj
from repro_torch.kernels import ingest_fused as fi
from repro_torch.kernels import sketch_update as su

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,cap_r,cap_s,c",
    [(1, 8, 8, 1), (4, 32, 16, 1), (3, 600, 700, 2), (8, 128, 2100, 3), (5, 1000, 3, 1)],
)
def test_reducer_join_kernel_matches_plain(cuda, k, cap_r, cap_s, c):
    rng = np.random.default_rng(k + cap_r + cap_s + c)
    ops = [
        rng.integers(0, 6, (k, cap_r, c)), rng.integers(-2, 5, (k, cap_r)),
        rng.integers(0, 6, (k, cap_s, c)), rng.integers(-2, 5, (k, cap_s)),
    ]
    ops = [torch.from_numpy(o.astype(np.int32)).to(cuda) for o in ops]
    before = bj.LAUNCHES["reducer_join"]
    got = bj.reducer_join(*ops)
    torch.cuda.synchronize()
    assert bj.LAUNCHES["reducer_join"] == before + 1
    want = bj.block_join_ref(*ops)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flat_join_kernel_wraparound(cuda):
    n = 5000
    keys = torch.zeros((n, 1), dtype=torch.int32, device=cuda)
    w = torch.full((n,), 40_000, dtype=torch.int32, device=cuda)
    cnt, chk = bj.flat_join(keys, w, keys, w)
    assert int(cnt) == n * n
    assert int(chk) & 0xFFFFFFFF == (40_000 * 40_000 * n * n) % (1 << 32)


@pytest.mark.parametrize("name", ["2way", "3way"])
def test_run_join_on_card_matches_cpu(cuda, name):
    rng = np.random.default_rng(0)
    if name == "2way":
        query, data, q = tcore.two_way(), tdata.paper_2way(rng, 20_000, 2_000, 30_000), 100
    else:
        query, data, q = tcore.three_way_paper(), tdata.paper_3way(rng, 2_000, 20_000), 120
    plan = tcore.plan_shares_skew(query, data, q=q)
    got = tmr.run_join(query, data, plan, cap_factor=5.0, device=cuda)
    want = tmr.run_join(query, data, plan, cap_factor=5.0, device="cpu")
    assert (got.count, got.checksum, got.overflow) == (want.count, want.checksum, 0)
    assert got.comm_tuples == want.comm_tuples
    np.testing.assert_array_equal(got.reducer_loads, want.reducer_loads)
    assert (got.count, got.checksum) == tmr.oracle_join(query, data)[:2]


# ---- the fused ingest pass (K2, K3) and the Count-Min update (K4) ----------

_I32 = np.iinfo(np.int32)
_CMS_SEEDS = (11, 222, (1 << 31) + 5, (1 << 32) - 1)


def _skewed_plan(query, q):
    rng = np.random.default_rng(7)
    data = {r.name: rng.integers(0, 50, (600, r.arity)).astype(np.int64) for r in query.relations}
    for r in query.relations:
        data[r.name][:300, -1] = 7
    return tcore.plan_shares_skew(query, data, q=q)


def _rows(n, arity, seed):
    rows = np.random.default_rng(seed).integers(0, 60, (n, arity)).astype(np.int32)
    if n >= 4:
        rows[-1], rows[-2], rows[-3, 0] = _I32.min, _I32.max, 7
    return rows


def _same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 30_000])
@pytest.mark.parametrize("name", ["2way", "3way"])
def test_fused_ingest_dense_kernel_matches_plain(cuda, name, n):
    query = tcore.two_way() if name == "2way" else tcore.three_way_paper()
    plan = _skewed_plan(query, q=8)
    k_pad = -(-plan.total_reducers // 128) * 128
    for rel in query.relations:
        routes = tmr.keys.static_route_table(plan, rel)
        w = fi.route_width(routes)
        enc = fi.dense_route_encoding(routes, rel.arity, 1 << max(0, (w - 1).bit_length()), 8)
        rows = torch.from_numpy(_rows(n, rel.arity, seed=n)).to(cuda)
        kw = dict(sketch_cols=(rel.arity - 1,), seeds=_CMS_SEEDS, width=2048, k_pad=k_pad)
        before = fi.LAUNCHES["fused_ingest_dense"]
        got = fi.fused_ingest_dense(rows, enc, **kw)
        torch.cuda.synchronize()
        assert fi.LAUNCHES["fused_ingest_dense"] == before + (1 if n else 0)
        _same(got, fi.fused_ingest_dense_ref(rows, enc, **kw))


@pytest.mark.parametrize("k_pad", [128, 65_536])
def test_fused_ingest_dense_kernel_repeated_destinations(cuda, k_pad):
    """Columns that collide within a row and across rows, and a histogram
    as wide as 65,536 destinations."""
    rng = np.random.default_rng(k_pad)
    wp, arity = 8, 3
    enc = fi.dense_route_encoding((), arity, wp, max_values=2)
    enc["col_valid"][:7] = 1
    enc["col_base"][:] = [0, 0, 3, 5, 5, 1, 2, 9]
    enc["col_base"][:7] += k_pad - 20
    enc["h_col"][:, 0] = rng.integers(0, arity, wp)
    enc["h_seed"][:, 0] = rng.integers(_I32.min, _I32.max, wp)
    enc["h_dim"][:, 0] = [2, 3, 1, 4, 4, 2, 1, 1]
    enc["h_stride"][:, 0] = [1, 1, 0, 2, 2, 3, 0, 0]
    enc["p_col"][3, 0], enc["p_val"][3, 0], enc["p_on"][3, 0] = 1, 2, 1
    enc["e_col"][5, 1], enc["e_val"][5, 1], enc["e_on"][5, 1] = 2, [0, 4], [1, 1]
    rows = torch.from_numpy(rng.integers(0, 5, (50_001, arity)).astype(np.int32)).to(cuda)
    _same(fi.fused_ingest_dense(rows, enc, k_pad=k_pad),
          fi.fused_ingest_dense_ref(rows, enc, k_pad=k_pad))


@pytest.mark.parametrize("mode", ["route", "sketch", "both"])
def test_fused_ingest_static_kernel_matches_plain(cuda, mode):
    query = tcore.two_way()
    plan = _skewed_plan(query, q=8)
    assert plan.total_reducers % 128
    rel = query.relations[1]
    kw = dict(
        routes=tmr.keys.static_route_table(plan, rel) if mode != "sketch" else (),
        sketch_cols=(0, 1) if mode != "route" else (), seeds=_CMS_SEEDS, width=100,
        num_reducers=plan.total_reducers,
    )
    rows = torch.from_numpy(_rows(10_007, rel.arity, seed=3)).to(cuda)
    counter = "fused_ingest_sketch" if mode == "sketch" else "fused_ingest"
    before = fi.LAUNCHES[counter]
    got = fi.fused_ingest(rows, **kw)
    torch.cuda.synchronize()
    assert fi.LAUNCHES[counter] == before + 1
    _same(got, fi.fused_ingest_ref(rows, **kw))


@pytest.mark.parametrize("width", [1, 251, 2048, 20_000])
def test_cms_update_kernel_matches_plain(cuda, width):
    rng = np.random.default_rng(width)
    vals = rng.integers(_I32.min, _I32.max, 100_003, dtype=np.int64, endpoint=True)
    vals[:2] = [_I32.min, _I32.max]
    vals[2:60_000] = 42  # a heavy key: many equal buckets in one warp
    vals = torch.from_numpy(vals.astype(np.int32)).to(cuda)
    before = su.LAUNCHES["cms_update"]
    got = su.cms_update(vals, _CMS_SEEDS, width)
    torch.cuda.synchronize()
    assert su.LAUNCHES["cms_update"] == before + 1
    assert torch.equal(got, su.cms_update_ref(vals, _CMS_SEEDS, width))


def _stream_batches():
    rng = np.random.default_rng(0)
    batches = []
    for i in range(5):
        shift, a = (0, 2.0) if i < 2 else (2000, 1.4)
        b_r = ((rng.zipf(a, 3000) - 1) + shift) % 8000
        b_s = ((rng.zipf(a, 800) - 1) + shift) % 8000
        batches.append({
            "R": np.stack([rng.integers(0, 8000, 3000), b_r], 1).astype(np.int64),
            "S": np.stack([b_s, rng.integers(0, 8000, 800)], 1).astype(np.int64),
        })
    return batches


def test_fused_stream_on_card_matches_oracle(cuda):
    batches = _stream_batches()
    cfg = tstream.StreamConfig(q=100, decay=0.5, load_factor=2.0, fused_ingest=True)
    fi.reset_launches()
    card = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device=cuda)
    host = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device="cpu")
    for b in batches:
        assert card.ingest(b) == host.ingest(b)
    assert fi.LAUNCHES["fused_ingest_dense"] > 0 and fi.LAUNCHES["fused_ingest_sketch"] > 0
    assert card.fused_batches == len(batches) and card.replan_count >= 1
    want = tmr.groupby_oracle_two_way(tcore.two_way(), card.history_data())
    assert (card.total_count, card.total_checksum) == want


def test_static_route_stream_on_card_matches_host(cuda):
    """The static-table pass (``fused_dynamic_routes=False``) on the card."""
    cfg = tstream.StreamConfig(q=100, decay=0.5, load_factor=2.0, fused_ingest=True,
                               fused_dynamic_routes=False)
    fi.reset_launches()
    card = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device=cuda)
    host = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device="cpu")
    for b in _stream_batches():
        assert card.ingest(b) == host.ingest(b)
    assert fi.LAUNCHES["fused_ingest"] > 0 and fi.LAUNCHES["fused_ingest_dense"] == 0
