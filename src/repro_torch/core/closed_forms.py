"""Closed forms for shares and communication cost (paper §1.1, §3, §7.3, §8).

Every formula here is cross-checked against the numeric geometric-program
solver in ``shares.py`` by tests/test_core_shares.py and, for this copy,
tests/test_torch_closed_forms.py.

Validity note: the Lagrangean closed forms ignore the x_i >= 1 bound; for
extremely lopsided relation sizes the unconstrained optimum may push a share
below 1, in which case the numeric solver (which enforces the bound) is the
ground truth.  Each function documents its assumption.
"""
from __future__ import annotations

import math
from typing import Sequence


# ---------------------------------------------------------------------------
# 2-way join R(A,B) ⋈ S(B,C)   (Examples 1-2, §5.3, §7.3)
# ---------------------------------------------------------------------------

def two_way_naive_cost(r: float, s: float, k: float) -> float:
    """Example 1: partition the larger relation into k buckets, broadcast the
    smaller to all k reducers.  cost = larger + k * smaller."""
    big, small = max(r, s), min(r, s)
    return big + k * small


def two_way_skew_shares(r: float, s: float, k: float) -> tuple[float, float]:
    """Example 2: minimize r*y + s*x  s.t. x*y = k.
    x partitions R (i.e. hashes A), y partitions S (hashes C).
    Returns (x, y)."""
    x = math.sqrt(k * r / s)
    y = math.sqrt(k * s / r)
    return x, y


def two_way_skew_cost(r: float, s: float, k: float) -> float:
    """Example 2 / §7.3: optimal HH-residual communication = 2*sqrt(k*r*s)."""
    return 2.0 * math.sqrt(k * r * s)


def two_way_lower_bound(r: float, s: float, k: float) -> float:
    """§7.3 lower bound — equals the achieved cost (SharesSkew is optimal)."""
    return 2.0 * math.sqrt(k * r * s)


# ---------------------------------------------------------------------------
# 3-relation chain R(A,B) ⋈ S(B,C) ⋈ T(C,D)   (Example 3)
# ---------------------------------------------------------------------------

def three_chain_shares(r: float, s: float, t: float, k: float) -> tuple[float, float]:
    """Example 3: shares (x, y) for (B, C); A and D are dominated."""
    x = math.sqrt(k * r / t)
    y = math.sqrt(k * t / r)
    return x, y


def three_chain_cost(r: float, s: float, t: float, k: float) -> float:
    """Example 3: cost = r*y + s + t*x = s + 2*sqrt(k*r*t)."""
    return s + 2.0 * math.sqrt(k * r * t)


# ---------------------------------------------------------------------------
# Triangle / cyclic 3-way join (§3)
# ---------------------------------------------------------------------------

def triangle_shares(r1: float, r2: float, r3: float, k: float) -> tuple[float, float, float]:
    x1 = (k * r1 * r3 / r2**2) ** (1.0 / 3.0)
    x2 = (k * r1 * r2 / r3**2) ** (1.0 / 3.0)
    x3 = (k * r2 * r3 / r1**2) ** (1.0 / 3.0)
    return x1, x2, x3


def triangle_cost(r1: float, r2: float, r3: float, k: float) -> float:
    return 3.0 * (k * r1 * r2 * r3) ** (1.0 / 3.0)


# ---------------------------------------------------------------------------
# Chain joins  R_1(A0,A1) ⋈ ... ⋈ R_n(A_{n-1},A_n)   (§8.1-8.2)
# ---------------------------------------------------------------------------

def chain_cost_equal_sizes(n: int, r: float, k: float) -> float:
    """§8.1 (even n): cost = n * r * k^{(n-2)/n}."""
    if n % 2 != 0:
        raise ValueError("closed form stated for even-length chains")
    return n * r * k ** ((n - 2) / n)


def chain_cost(sizes: Sequence[float], k: float) -> float:
    """§8.2 (even n, arbitrary sizes):

    cost = n/2 * k^{(n-2)/n} * ((r1 r3 r5 ...)^{2/n} + (r2 r4 ...)^{2/n})
    """
    n = len(sizes)
    if n % 2 != 0:
        raise ValueError("closed form stated for even-length chains")
    odd = math.prod(sizes[0::2])   # r1, r3, ... (1-indexed odd)
    even = math.prod(sizes[1::2])  # r2, r4, ...
    lam1 = k ** (1 - 2 / n) * odd ** (2 / n)
    lam2 = k ** (1 - 2 / n) * even ** (2 / n)
    return (n / 2) * (lam1 + lam2)


def chain_shares(sizes: Sequence[float], k: float) -> list[float]:
    """§8.2 shares a_1..a_{n-1} for interior attributes A_1..A_{n-1} (even n),
    via the forward recursion  tau_i = r_i k / (a_{i-1} a_i) = lambda_parity.

    Returns the list [a_1, ..., a_{n-1}].  Raises if the unconstrained
    optimum violates a_i >= 1 (caller should fall back to the solver)."""
    n = len(sizes)
    if n % 2 != 0:
        raise ValueError("closed form stated for even-length chains")
    odd = math.prod(sizes[0::2])
    even = math.prod(sizes[1::2])
    lam1 = k ** (1 - 2 / n) * odd ** (2 / n)
    lam2 = k ** (1 - 2 / n) * even ** (2 / n)
    shares = []
    prev = 1.0  # a_0 (A_0 is dominated -> share 1)
    for i, r_i in enumerate(sizes[:-1], start=1):  # a_1 .. a_{n-1}
        lam = lam1 if i % 2 == 1 else lam2
        a_i = r_i * k / (lam * prev)
        shares.append(a_i)
        prev = a_i
    if any(a < 1.0 - 1e-6 for a in shares):
        raise ValueError(f"closed-form share < 1 (sizes too lopsided): {shares}")
    # consistency: product of shares must be k, last term must balance
    prod = math.prod(shares)
    if not math.isclose(prod, k, rel_tol=1e-6):
        raise AssertionError(f"share product {prod} != k {k}")
    return shares


def subchain_budgets(
    subchain_lengths: Sequence[int],
    k: float,
    subchain_coeffs: Sequence[float] | None = None,
) -> list[float]:
    """§8.1: a chain with m-1 heavy hitters splits into m sub-chains; subchain
    i with n_i relations costs  C_i * k_i^{(n_i-2)/n_i}.  Minimize the sum
    subject to prod k_i = k.

    ``subchain_coeffs`` C_i defaults to n_i (equal unit sizes).  Subchains
    with n_i <= 2 have exponent <= 0 -- they get k_i = 1 (no benefit from
    more reducers).  Solved exactly in log-space (convex); the paper's
    balance condition  (n_i-2) k_i^{(n_i-2)/n_i} = const  is verified in
    tests.
    """
    ns = list(subchain_lengths)
    if subchain_coeffs is None:
        coeffs = [float(n) for n in ns]
    else:
        coeffs = [float(c) for c in subchain_coeffs]
    alphas = [(n - 2) / n for n in ns]
    active = [i for i, a in enumerate(alphas) if a > 0]
    out = [1.0] * len(ns)
    if not active:
        return out
    log_k = math.log(k)
    # minimize sum_i C_i e^{alpha_i y_i}  s.t. sum y_i = log k, y_i >= 0.
    # Lagrangean: C_i alpha_i e^{alpha_i y_i} = lam  ->  y_i(lam) =
    # log(lam/(C_i alpha_i)) / alpha_i ; bisect on lam to satisfy sum = log k.
    def ysum(lam: float) -> float:
        s = 0.0
        for i in active:
            y = math.log(lam / (coeffs[i] * alphas[i])) / alphas[i]
            s += max(0.0, y)
        return s

    lo = min(coeffs[i] * alphas[i] for i in active) * 1e-12
    hi = max(coeffs[i] * alphas[i] for i in active) * 1e12
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if ysum(mid) < log_k:
            lo = mid
        else:
            hi = mid
    lam = math.sqrt(lo * hi)
    for i in active:
        y = max(0.0, math.log(lam / (coeffs[i] * alphas[i])) / alphas[i])
        out[i] = math.exp(y)
    # renormalize tiny bisection error onto the largest budget
    prod = math.prod(out)
    j = max(active, key=lambda i: out[i])
    out[j] *= k / prod
    return out


# ---------------------------------------------------------------------------
# Symmetric joins (§8.3, Theorem 2)
# ---------------------------------------------------------------------------

def symmetric_cost(n: int, d: int, sizes: Sequence[float], k: float) -> float:
    """Theorem 2:  cost = n_d * k^{1-d/n} * sum_S (prod_{i in S} r_i)^{1/n_d}

    where n_d = smallest integer with n | d*n_d  (= n / gcd(n, d)) and the
    S are the gcd(n,d) cosets {R_j, R_{j+d}, R_{j+2d}, ...} (0-indexed).
    """
    if len(sizes) != n:
        raise ValueError("need one size per relation")
    g = math.gcd(n, d)
    n_d = n // g
    total = 0.0
    for j in range(g):
        prod = 1.0
        for step in range(n_d):
            prod *= sizes[(j + step * d) % n]
        total += prod ** (1.0 / n_d)
    return n_d * k ** (1.0 - d / n) * total


def symmetric_cost_equal_sizes(n: int, d: int, r: float, k: float) -> float:
    """Equal sizes: Theorem 2 collapses to  n * r * k^{1-d/n}."""
    return n * r * k ** (1.0 - d / n)


def symmetric_shares_equal_sizes(n: int, k: float) -> float:
    """Equal sizes: all n attributes take the same share k^{1/n}."""
    return k ** (1.0 / n)
