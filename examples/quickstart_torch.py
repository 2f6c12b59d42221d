"""Quickstart on PyTorch: SharesSkew in ~50 lines, on the card.

The twin of ``examples/quickstart.py`` through the port (``repro_torch``):
plan and execute a skewed 2-way join R(A,B) ⋈ S(B,C) (the reduce is the
block-join kernel on the card), verify against the host oracle, and print
the communication savings over the naive partition/broadcast skew join
(paper Examples 1-2).  The same data and plan give the same fingerprint as
the JAX twin.  ``--device`` defaults to ``cuda`` and fails without a card;
``--device cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import plan_shares_skew, two_way
from repro_torch.data import paper_2way
from repro_torch.mapreduce import naive_two_way, oracle_join, run_join


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda", help="where the join runs (default: cuda)")
    args = parser.parse_args(argv)

    # 1. skewed data: |R| = 10 * |S|, one heavy hitter (B=7) in 10% of tuples
    rng = np.random.default_rng(0)
    data = paper_2way(rng, n_r=20_000, n_s=2_000, domain=30_000)

    # 2. plan: detect heavy hitters, build residual joins, solve shares
    plan = plan_shares_skew(two_way(), data, q=100)
    print(plan.describe())

    # 3. execute on the PyTorch MapReduce engine (map -> bin -> reduce)
    result = run_join(two_way(), data, plan, cap_factor=4.0, device=args.device)
    count, checksum, _, _ = oracle_join(two_way(), data)
    assert (result.count, result.checksum) == (count, checksum)
    print(f"\njoin count={result.count}  (verified against host oracle)")
    print(f"shuffled tuples={result.total_comm}  max reducer load={result.max_load}")

    # 4. compare with the naive skew join (partition big side, broadcast small)
    hh = next(r for r in plan.residuals if r.combo.pinned)
    naive = naive_two_way(
        data["R"], data["S"], np.array([7]),
        k_hh=hh.num_reducers, k_ord=plan.total_reducers - hh.num_reducers,
    )
    saving = 100 * (1 - result.total_comm / naive.comm_tuples)
    print(f"naive shuffle={naive.comm_tuples}  ->  SharesSkew saves {saving:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
