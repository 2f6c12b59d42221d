"""The torch port's map phase against the JAX package's: routing recipes and
destination blocks, bit for bit, on plans with heavy-hitter pins and
ordinary-type excludes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.data import paper_2way, paper_3way, random_join_data
from repro.mapreduce import keys as jkeys
from repro_torch.core import plan_from_arrays, plan_to_arrays
from repro_torch.mapreduce import keys as tkeys


_SEEDS = {"2way": 4, "3way_paper": 10, "chain": 5, "symmetric": 9}


def _case(name):
    rng = np.random.default_rng(_SEEDS[name])
    if name == "2way":
        q = jcore.two_way()
        return q, paper_2way(rng, n_r=2000, n_s=400, domain=1500), 150
    if name == "3way_paper":
        q = jcore.three_way_paper()
        return q, paper_3way(rng, n=800, domain=3000), 40
    if name == "chain":
        q = jcore.chain_join(4)
        return q, random_join_data(rng, q, 400, 300, skew_attr="A2",
                                   hh_values=[5], hh_fraction=0.5), 100
    if name == "symmetric":
        q = jcore.symmetric_join(4, 2)
        return q, random_join_data(rng, q, 500, 300, skew_attr="A1",
                                   hh_values=[3], hh_fraction=0.3), 150
    raise KeyError(name)


@pytest.mark.parametrize("name", ["2way", "3way_paper", "chain", "symmetric"])
def test_map_phase_matches_reference(name):
    query, data, q = _case(name)
    jplan = jcore.plan_shares_skew(query, data, q=q)
    tplan = plan_from_arrays(**plan_to_arrays(jplan))
    assert jplan.hh_values, "the case must exercise heavy-hitter routing"
    pins = excludes = 0
    for rel in query.relations:
        jspecs = jkeys.build_route_specs(jplan, rel)
        tspecs = tkeys.build_route_specs(tplan, rel)
        assert [dataclass_tuple(s) for s in tspecs] == [dataclass_tuple(s) for s in jspecs]
        assert tkeys.static_route_table(tplan, rel) == jkeys.static_route_table(jplan, rel)
        pins += sum(len(s.pins) for s in tspecs)
        excludes += sum(len(s.ordinary_excludes) for s in tspecs)
        rows = np.asarray(data[rel.name]).astype(np.int32)
        want = np.asarray(jkeys.map_phase(jplan, rel, jnp.asarray(rows)))
        got = tkeys.map_phase(tplan, rel, torch.from_numpy(rows))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for s in tspecs:
            assert s.replication == next(
                j for j in jspecs if j.residual_index == s.residual_index
            ).replication
    assert pins > 0 and excludes > 0


def dataclass_tuple(spec):
    return (spec.rel_name, spec.residual_index, spec.offset, spec.hashed,
            spec.replicated, spec.pins, spec.ordinary_excludes)


def test_column_layout_residual_major_replica_minor():
    query, data, q = _case("2way")
    tplan = plan_from_arrays(**plan_to_arrays(jcore.plan_shares_skew(query, data, q=q)))
    rel = query.relations[1]  # S(B, C): replicated over A in the HH residual
    rows = torch.from_numpy(np.asarray(data["S"]).astype(np.int32))
    dest = tkeys.map_phase(tplan, rel, rows)
    col = 0
    for spec in tkeys.build_route_specs(tplan, rel):
        block = dest[:, col: col + spec.replication]
        np.testing.assert_array_equal(block.numpy(), spec.destinations(rows).numpy())
        col += spec.replication
    assert col == dest.shape[1]
