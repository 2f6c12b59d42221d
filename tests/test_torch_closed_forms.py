"""The port's copy of the paper's closed forms (``repro_torch.core``)
against the JAX package's, float for float on a grid of sizes and k, and
against the port's own share solver with ``tests/test_core_shares.py``'s
checks and tolerances (§1.1, §3, §7.3, §8)."""
import itertools
import math
import re

import pytest

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core import (
    chain_cost,
    chain_cost_equal_sizes,
    chain_join,
    chain_shares,
    make_query,
    solve_shares,
    subchain_budgets,
    symmetric_cost,
    symmetric_cost_equal_sizes,
    symmetric_join,
    three_chain_cost,
    triangle,
    triangle_cost,
    triangle_shares,
    two_way,
    two_way_naive_cost,
    two_way_skew_cost,
    two_way_skew_shares,
)

CLOSED_FORMS = (
    "chain_cost", "chain_cost_equal_sizes", "chain_shares", "subchain_budgets",
    "symmetric_cost", "symmetric_cost_equal_sizes", "symmetric_shares_equal_sizes",
    "three_chain_cost", "three_chain_shares", "triangle_cost", "triangle_shares",
    "two_way_lower_bound", "two_way_naive_cost", "two_way_skew_cost", "two_way_skew_shares",
)
_SIZES = (1.0, 37.0, 1e3, 5e4, 1e5, 2e6)
_KS = (1, 2, 16, 100, 4096, 1 << 16)


def test_port_exports_every_closed_form():
    assert set(CLOSED_FORMS) <= set(tcore.__all__)
    assert set(CLOSED_FORMS) == {n for n in jcore.__all__ if n in CLOSED_FORMS}


def _same(name, *args):
    """Equal floats, or the same refusal (a form stated for some inputs
    only raises ValueError on the others)."""
    try:
        want = getattr(jcore, name)(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            getattr(tcore, name)(*args)
        return
    got = getattr(tcore, name)(*args)
    assert got == want, (name, args)
    assert type(got) is type(want)


@pytest.mark.parametrize("k", _KS)
def test_two_and_three_relation_forms_equal_reference(k):
    for r, s in itertools.product(_SIZES, repeat=2):
        for name in ("two_way_naive_cost", "two_way_skew_shares", "two_way_skew_cost",
                     "two_way_lower_bound"):
            _same(name, r, s, k)
        for t in _SIZES[::2]:
            for name in ("three_chain_shares", "three_chain_cost", "triangle_shares",
                         "triangle_cost"):
                _same(name, r, s, t, k)


@pytest.mark.parametrize("k", _KS)
def test_chain_and_symmetric_forms_equal_reference(k):
    for n in (2, 3, 4, 6, 9):
        for r in _SIZES:
            _same("chain_cost_equal_sizes", n, r, k)
            _same("symmetric_shares_equal_sizes", n, k)
            for d in range(1, n):
                _same("symmetric_cost_equal_sizes", n, d, r, k)
        for sizes in itertools.islice(itertools.product(_SIZES[1:], repeat=n), 0, 40, 7):
            _same("chain_cost", list(sizes), k)
            _same("chain_shares", list(sizes), k)
            for d in range(1, n):
                _same("symmetric_cost", n, d, list(sizes), k)
    for ns in ([4], [2, 4], [4, 6], [3, 5, 7], [6, 6, 2]):
        _same("subchain_budgets", ns, k)


# ---- tests/test_core_shares.py's checks against the port's solver ----------

@pytest.mark.parametrize("r,s,k", [(1e6, 1e5, 64), (1e5, 1e5, 16), (5e4, 2e6, 256)])
def test_two_way_skew_matches_solver(r, s, k):
    sol = solve_shares(two_way(), {"R": r, "S": s}, k, fixed_to_one={"B"})
    assert sol.cost == pytest.approx(two_way_skew_cost(r, s, k), rel=1e-4)
    x, y = two_way_skew_shares(r, s, k)
    assert sol.shares["A"] == pytest.approx(x, rel=1e-3)
    assert sol.shares["C"] == pytest.approx(y, rel=1e-3)


def test_two_way_beats_naive():
    r, s, k = 1e6, 1e5, 64
    assert two_way_skew_cost(r, s, k) < two_way_naive_cost(r, s, k)


def test_triangle_matches_solver():
    r1, r2, r3, k = 1e5, 2e5, 1.5e5, 64
    sol = solve_shares(triangle(), {"R1": r1, "R2": r2, "R3": r3}, k)
    assert sol.cost == pytest.approx(triangle_cost(r1, r2, r3, k), rel=1e-4)
    for a, x in zip(("X1", "X2", "X3"), triangle_shares(r1, r2, r3, k)):
        assert sol.shares[a] == pytest.approx(x, rel=1e-3)


def test_three_chain_matches_solver():
    r, s, t, k = 4e5, 1e5, 2e5, 100
    q = make_query({"R": ("A", "B"), "S": ("B", "C"), "T": ("C", "D")})
    sol = solve_shares(q, {"R": r, "S": s, "T": t}, k)
    assert sol.cost == pytest.approx(three_chain_cost(r, s, t, k), rel=1e-4)


@pytest.mark.parametrize("n,k", [(4, 256), (6, 4096)])
def test_chain_equal_sizes_matches_solver(n, k):
    r = 1e5
    sol = solve_shares(chain_join(n), {f"R{i+1}": r for i in range(n)}, k)
    assert sol.cost == pytest.approx(chain_cost_equal_sizes(n, r, k), rel=1e-3)


def test_chain_arbitrary_sizes_matches_solver():
    sizes_list = [2e5, 1e5, 3e5, 1.5e5]
    k = 4096.0
    sol = solve_shares(chain_join(4), {f"R{i+1}": s for i, s in enumerate(sizes_list)}, k)
    assert sol.cost == pytest.approx(chain_cost(sizes_list, k), rel=1e-3)
    shares = chain_shares(sizes_list, k)
    assert math.prod(shares) == pytest.approx(k, rel=1e-6)
    for a, expect in zip(("A1", "A2", "A3"), shares):
        assert sol.shares[a] == pytest.approx(expect, rel=1e-2)


def test_subchain_budgets_balance():
    ns, k = [4, 6], 1 << 16
    ks = subchain_budgets(ns, k)
    assert math.prod(ks) == pytest.approx(k, rel=1e-6)
    bal = [n * ((n - 2) / n) * kk ** ((n - 2) / n) for n, kk in zip(ns, ks)]
    assert bal[0] == pytest.approx(bal[1], rel=1e-3)


def test_subchain_degenerate_gets_one():
    ks = subchain_budgets([2, 4], 256)
    assert ks[0] == pytest.approx(1.0)
    assert ks[1] == pytest.approx(256.0)


@pytest.mark.parametrize("n,d,k", [(3, 2, 64), (4, 2, 256), (5, 3, 1024), (6, 4, 4096)])
def test_symmetric_equal_sizes_matches_solver(n, d, k):
    r = 1e5
    sol = solve_shares(symmetric_join(n, d), {f"R{j+1}": r for j in range(n)}, k)
    assert sol.cost == pytest.approx(symmetric_cost_equal_sizes(n, d, r, k), rel=1e-3)
    assert sol.cost == pytest.approx(symmetric_cost(n, d, [r] * n, k), rel=1e-3)


def test_symmetric_arbitrary_sizes_matches_solver():
    n, d, k = 4, 2, 256.0
    sizes_list = [1e5, 1.5e5, 1e5, 1.5e5]  # balanced enough for interior optimum
    sol = solve_shares(symmetric_join(n, d), {f"R{j+1}": s for j, s in enumerate(sizes_list)}, k)
    assert sol.cost == pytest.approx(symmetric_cost(n, d, sizes_list, k), rel=1e-3)


def test_symmetric_beats_chain_scaling():
    n, r, k = 6, 1e5, 4096
    assert symmetric_cost_equal_sizes(n, 5, r, k) < symmetric_cost_equal_sizes(n, 2, r, k)
    assert symmetric_cost_equal_sizes(n, n - 1, r, k) < chain_cost_equal_sizes(n, r, k)
