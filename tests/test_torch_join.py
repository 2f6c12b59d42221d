"""The torch port's batch join end to end against the JAX package's
``run_join`` and ``oracle_join``, on the very same plan; the two planners
against each other; and the port's host oracles."""
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import data as jdata
from repro import mapreduce as jmr
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch import mapreduce as tmr


def _data(name):
    rng = np.random.default_rng(0)
    if name == "2way":
        return jcore.two_way(), jdata.paper_2way(rng, n_r=1500, n_s=300, domain=1000), 120, 4.0
    if name == "3way_paper":
        return jcore.three_way_paper(), jdata.paper_3way(rng, n=400, domain=300), 150, 4.0
    if name == "triangle":
        return jcore.triangle(), jdata.random_join_data(rng, jcore.triangle(), 150, 25), 120, 4.0
    if name == "empty":
        return jcore.two_way(), {"R": np.zeros((0, 2), np.int64),
                                 "S": np.array([[1, 2], [3, 4]], np.int64)}, 100, 3.0
    if name == "one_value":
        n = 120
        return jcore.two_way(), {
            "R": np.stack([rng.integers(0, 1000, n), np.full(n, 7)], 1).astype(np.int64),
            "S": np.stack([np.full(n, 7), rng.integers(0, 1000, n)], 1).astype(np.int64),
        }, 40, 6.0
    raise KeyError(name)


def _tq(query):
    """The port's JoinQuery for a reference JoinQuery."""
    return tcore.make_query({r.name: r.attrs for r in query.relations})


def _same_plan(jplan):
    return tcore.plan_from_arrays(**tcore.plan_to_arrays(jplan))


@pytest.mark.parametrize("name", ["2way", "3way_paper", "triangle", "empty", "one_value"])
def test_run_join_matches_reference_and_oracle(name):
    query, data, q, cap_factor = _data(name)
    jplan = jcore.plan_shares_skew(query, data, q=q)
    tplan = _same_plan(jplan)
    want = jmr.run_join(query, data, jplan, cap_factor=cap_factor)
    got = tmr.run_join(_tq(query), data, tplan, cap_factor=cap_factor, device="cpu")
    count, checksum, _, _ = jmr.oracle_join(query, data)
    assert got.overflow == want.overflow == 0
    assert (got.count, got.checksum) == (want.count, want.checksum) == (count, checksum)
    assert got.comm_tuples == want.comm_tuples == tmr.predicted_comm(tplan)
    np.testing.assert_array_equal(got.reducer_loads, want.reducer_loads)
    assert got.reducer_loads.dtype == np.int32
    assert got.reducer_loads.sum() == got.total_comm
    if name == "one_value":
        assert got.count == 120 * 120
    if name == "empty":
        assert got.count == 0 and got.reducer_loads.size == 0


def test_run_join_reports_overflow_like_reference():
    query, data, q, _ = _data("2way")
    jplan = jcore.plan_shares_skew(query, data, q=q)
    want = jmr.run_join(query, data, jplan, cap_factor=0.05)  # cap 16 < loads
    got = tmr.run_join(_tq(query), data, _same_plan(jplan), cap_factor=0.05, device="cpu")
    assert got.overflow == want.overflow > 0
    assert (got.count, got.checksum) == (want.count, want.checksum)


def test_run_join_phase_seconds_and_cuda_without_card():
    query, data, q, cap_factor = _data("2way")
    query = _tq(query)
    plan = tcore.plan_shares_skew(query, data, q=q)
    phases = {}
    tmr.run_join(query, data, plan, cap_factor=cap_factor, device="cpu", phase_seconds=phases)
    assert set(phases) == {"upload", "map", "bin", "reduce"}
    assert all(v >= 0 for v in phases.values())
    if not torch.cuda.is_available():  # entry points never fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmr.run_join(query, data, plan)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmr.measure_loads(query, data, plan)


@pytest.mark.parametrize("name", ["2way", "3way_paper", "triangle", "one_value"])
def test_planners_agree(name):
    query, data, q, _ = _data(name)
    jplan = jcore.plan_shares_skew(query, data, q=q)
    tplan = tcore.plan_shares_skew(_tq(query), data, q=q)
    assert tplan.describe() == jplan.describe()
    assert tcore.plan_to_arrays(tplan).keys() == tcore.plan_to_arrays(jplan).keys()
    ta, ja = tcore.plan_to_arrays(tplan), tcore.plan_to_arrays(jplan)
    assert ta["residuals"] == ja["residuals"]
    assert ta["hh_values"].keys() == ja["hh_values"].keys()
    for a in ta["hh_values"]:
        np.testing.assert_array_equal(ta["hh_values"][a], ja["hh_values"][a])
    assert [r.reducer_offset for r in tplan.residuals] == [r.reducer_offset for r in jplan.residuals]
    assert tplan.predicted_cost == jplan.predicted_cost


def test_plain_shares_planners_agree():
    query, data, _, _ = _data("3way_paper")
    jplan = jcore.plan_plain_shares(query, data, k=64)
    tplan = tcore.plan_plain_shares(_tq(query), data, k=64)
    assert tplan.describe() == jplan.describe()
    assert tcore.plan_to_arrays(tplan)["residuals"] == tcore.plan_to_arrays(jplan)["residuals"]


@pytest.mark.parametrize("name", ["2way", "3way_paper"])
def test_plan_from_arrays_round_trip(name):
    query, data, q, _ = _data(name)
    plan = tcore.plan_shares_skew(_tq(query), data, q=q)
    again = tcore.plan_from_arrays(**tcore.plan_to_arrays(plan))
    assert again.describe() == plan.describe()
    assert again.query == plan.query
    for a, b in zip(again.residuals, plan.residuals):
        assert a.combo == b.combo and a.sizes == b.sizes and a.k_budget == b.k_budget
        assert a.reducer_offset == b.reducer_offset
        assert a.solution.int_shares == b.solution.int_shares
        assert a.solution.shares == b.solution.shares
        assert a.solution.cost_expr == b.solution.cost_expr
        assert (a.solution.k, a.solution.cost, a.solution.int_cost) == (
            b.solution.k, b.solution.cost, b.solution.int_cost)
    assert tmr.predicted_comm(again) == tmr.predicted_comm(plan)


@pytest.mark.parametrize("seed", [0, 1])
def test_groupby_oracle_matches_oracle_join(seed):
    rng = np.random.default_rng(seed)
    data = tdata.paper_2way(rng, n_r=3000, n_s=500, domain=400)
    want = tmr.oracle_join(tcore.two_way(), data)[:2]
    assert tmr.groupby_oracle_two_way(tcore.two_way(), data) == want
    assert want == jmr.oracle_join(jcore.two_way(), data)[:2]
    # two shared columns, and a cross product
    q2 = tcore.make_query({"R": ("A", "B", "C"), "S": ("B", "C", "D")})
    d2 = tdata.random_join_data(rng, q2, 400, 4)
    assert tmr.groupby_oracle_two_way(q2, d2) == tmr.oracle_join(q2, d2)[:2]
    qx = tcore.make_query({"R": ("A",), "S": ("B",)})
    dx = {"R": rng.integers(0, 9, (20, 1)), "S": rng.integers(0, 9, (15, 1))}
    assert tmr.groupby_oracle_two_way(qx, dx) == tmr.oracle_join(qx, dx)[:2] == (300, tmr.oracle_join(qx, dx)[1])


def test_data_generators_match_reference():
    for fn in ("paper_2way", "paper_3way"):
        want = getattr(jdata, fn)(np.random.default_rng(3))
        got = getattr(tdata, fn)(np.random.default_rng(3))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    q = jcore.chain_join(3)
    want = jdata.random_join_data(np.random.default_rng(4), q, 50, 30, "A1", [2], 0.3)
    got = tdata.random_join_data(np.random.default_rng(4), tcore.chain_join(3), 50, 30, "A1", [2], 0.3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_measure_loads_and_naive_match_reference():
    query, data, q, _ = _data("2way")
    jplan = jcore.plan_shares_skew(query, data, q=q)
    want = jmr.measure_loads(query, data, jplan)
    got = tmr.measure_loads(_tq(query), data, _same_plan(jplan), device="cpu")
    assert got.comm_tuples == want.comm_tuples
    np.testing.assert_array_equal(got.reducer_loads, want.reducer_loads)
    jn = jmr.naive_two_way(data["R"], data["S"], np.array([7]), k_hh=5, k_ord=12)
    tn = tmr.naive_two_way(data["R"], data["S"], np.array([7]), k_hh=5, k_ord=12)
    assert tn.comm_tuples == jn.comm_tuples
    np.testing.assert_array_equal(tn.reducer_loads, jn.reducer_loads)
