"""The torch port's reduce-phase primitives against the JAX package's: bins,
validity, loads, overflow and the local join's (count, checksum), bit for
bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.data import paper_2way, paper_3way, random_join_data
from repro.mapreduce import keys as jkeys
from repro.mapreduce import local_join as jlj
from repro_torch.core import plan_from_arrays, plan_to_arrays
from repro_torch.mapreduce import keys as tkeys
from repro_torch.mapreduce import local_join as tlj

# the reference's own jitted forms: the same integer math, compiled once
_jgroup = jax.jit(jlj.group_by_reducer, static_argnums=(2, 3))


@pytest.mark.parametrize(
    "m,k,cap,arity",
    [(0, 3, 4, 2), (500, 7, 16, 2), (2000, 13, 64, 3), (1500, 5, 300, 1)],
)
def test_group_by_reducer_matches_reference(m, k, cap, arity):
    rng = np.random.default_rng(m + k + cap)
    dests = rng.integers(-1, k, m).astype(np.int32)
    rows = rng.integers(-1000, 1000, (m, arity)).astype(np.int32)
    jb, jv, jl, jo = jlj.group_by_reducer(jnp.asarray(dests), jnp.asarray(rows), k, cap)
    tb, tv, tl, to = tlj.group_by_reducer(torch.from_numpy(dests), torch.from_numpy(rows), k, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32
    assert int(to) == int(jo)


def test_group_by_reducer_overflowing_cap():
    rng = np.random.default_rng(11)
    k, cap = 4, 10
    dests = np.concatenate([np.full(40, 2), rng.integers(-1, k, 60)]).astype(np.int32)
    rng.shuffle(dests)
    rows = np.arange(200, dtype=np.int32).reshape(100, 2)
    jb, jv, jl, jo = jlj.group_by_reducer(jnp.asarray(dests), jnp.asarray(rows), k, cap)
    tb, tv, tl, to = tlj.group_by_reducer(torch.from_numpy(dests), torch.from_numpy(rows), k, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    want_overflow = sum(max(0, int((dests == d).sum()) - cap) for d in range(k))
    assert int(to) == int(jo) == want_overflow > 0
    # the kept rows are the first `cap` arrivals, in input order
    first = rows[dests == 2][:cap]
    np.testing.assert_array_equal(tb[2].numpy(), first)


def _binned(query, data, q, cap):
    jplan = jcore.plan_shares_skew(query, data, q=q)
    tplan = plan_from_arrays(**plan_to_arrays(jplan))
    k = jplan.total_reducers
    jbins, jvals, tbins, tvals = {}, {}, {}, {}
    for rel in query.relations:
        rows = np.asarray(data[rel.name]).astype(np.int32)
        jd = jkeys.map_phase(jplan, rel, jnp.asarray(rows))
        n, w = jd.shape
        flat = np.repeat(rows, w, axis=0)
        jbins[rel.name], jvals[rel.name], _, _ = _jgroup(
            jd.reshape(-1), jnp.asarray(flat), k, cap)
        td = tkeys.map_phase(tplan, rel, torch.from_numpy(rows))
        tbins[rel.name], tvals[rel.name], _, _ = tlj.group_by_reducer(
            td.reshape(-1), torch.from_numpy(flat), k, cap)
    return jbins, jvals, tbins, tvals


def _cases():
    return {
        "2way": (jcore.two_way(), paper_2way(np.random.default_rng(0), n_r=1500, n_s=300, domain=1000), 120, 200),
        "3way_paper": (jcore.three_way_paper(), paper_3way(np.random.default_rng(2), n=400, domain=300), 150, 320),
        "triangle": (jcore.triangle(), random_join_data(np.random.default_rng(3), jcore.triangle(), 150, 25), 120, 240),
        "cross": (jcore.make_query({"R": ("A",), "S": ("B",)}),
                  {"R": np.arange(30).reshape(-1, 1), "S": np.arange(20).reshape(-1, 1)}, 100, 64),
    }


@pytest.mark.parametrize("name", ["2way", "3way_paper", "triangle", "cross"])
def test_local_join_count_checksum_matches_reference(name):
    query, data, q, cap = _cases()[name]
    jbins, jvals, tbins, tvals = _binned(query, data, q, cap)
    for n in jbins:
        np.testing.assert_array_equal(tbins[n].numpy(), np.asarray(jbins[n]))
    jspec = jlj.LocalJoinSpec.from_query(query)
    tspec = tlj.LocalJoinSpec.from_query(query)
    assert (tspec.rel_names, tspec.links) == (jspec.rel_names, jspec.links)
    assert tspec.is_binary == (name == "2way")
    jc, jk = jlj.local_join_count_checksum_jit(jspec, jbins, jvals)
    tc, tk = tlj.local_join_count_checksum(tspec, tbins, tvals)
    assert int(tc) == int(jc) > 0
    assert int(tk) == int(np.uint32(jk))


def test_nway_contraction_wraps_checksum_like_int32():
    """Large weights force the n-way checksum through mod-2^32 products."""
    spec = tlj.LocalJoinSpec.from_query(jcore.three_way_paper())
    rng = np.random.default_rng(5)
    k, cap = 3, 12
    bins = {n: torch.from_numpy(rng.integers(0, 2, (k, cap, a)).astype(np.int32))
            for n, a in (("R", 2), ("S", 3), ("T", 2))}
    valids = {n: torch.from_numpy(rng.random((k, cap)) < 0.8) for n in bins}
    weights = {n: torch.where(valids[n], torch.from_numpy(
        rng.integers(1 << 30, (1 << 31) - 1, (k, cap)).astype(np.int64)), 0) for n in bins}
    cnt, chk = tlj._nway_count_checksum(spec, bins, valids, weights)
    want_cnt, want_chk = 0, 0
    for kk in range(k):
        for a in range(cap):
            for b in range(cap):
                for c in range(cap):
                    r, s, t = bins["R"][kk, a], bins["S"][kk, b], bins["T"][kk, c]
                    if (valids["R"][kk, a] and valids["S"][kk, b] and valids["T"][kk, c]
                            and r[1] == s[0] and s[2] == t[0]):
                        want_cnt += 1
                        want_chk += (int(weights["R"][kk, a]) * int(weights["S"][kk, b])
                                     * int(weights["T"][kk, c]))
    assert int(cnt) == want_cnt > 0
    assert int(chk) == want_chk % (1 << 32)


def test_materialize_two_way_matches_reference():
    query, data, q, cap = _cases()["2way"]
    jbins, jvals, tbins, tvals = _binned(query, data, q, cap)
    spec_j = jlj.LocalJoinSpec.from_query(query)
    spec_t = tlj.LocalJoinSpec.from_query(query)
    for out_cap in (50, 100_000):
        jr, jo, jov = jlj.materialize_two_way(spec_j, jbins, jvals, out_cap)
        tr, to, tov = tlj.materialize_two_way(spec_t, tbins, tvals, out_cap)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert int(tov) == int(jov)


@pytest.mark.parametrize("limit", [1 << 12, 1 << 15, 200_000])  # 10, 2 and 1 slices
def test_binary_join_in_slices_below_the_pair_limit(monkeypatch, limit):
    """Bins whose cap_r * cap_s reaches the block join's pair limit go
    through it in slices of R's rows (the limit lowered here to reach the
    slicing at a CPU size): the same (count, checksum) as the JAX package's
    one join, and every launch below the limit."""
    from repro_torch.kernels import block_join

    query, data, q, cap = _cases()["2way"]
    jbins, jvals, tbins, tvals = _binned(query, data, q, cap)
    jspec = jlj.LocalJoinSpec.from_query(query)
    jc, jk = jlj.local_join_count_checksum_jit(jspec, jbins, jvals)
    calls = []
    inner = block_join.reducer_join

    def counted(r_keys, r_weights, s_keys, s_weights):
        assert r_keys.shape[1] * s_keys.shape[1] < limit
        calls.append(r_keys.shape[1])
        return inner(r_keys, r_weights, s_keys, s_weights)

    monkeypatch.setattr(block_join, "PAIR_LIMIT", limit)
    monkeypatch.setattr(block_join, "reducer_join", counted)
    tc, tk = tlj.local_join_count_checksum(tlj.LocalJoinSpec.from_query(query), tbins, tvals)
    assert int(tc) == int(jc) > 0
    assert int(tk) == int(np.uint32(jk))
    most = (limit - 1) // cap  # R rows a slice may hold beside cap S rows
    assert sum(calls) == cap and len(calls) == -(-cap // most)
    assert max(calls) - min(calls) <= 1  # equal slices
