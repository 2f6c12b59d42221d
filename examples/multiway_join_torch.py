"""Walkthrough of the paper's running example (Examples 5-8, §9.2) on
PyTorch, on the card.

The twin of ``examples/multiway_join.py`` through the port
(``repro_torch``): the 3-way join J = R(A,B) ⋈ S(B,E,C) ⋈ T(C,D), where B
has heavy hitters b1, b2 and C has c1.  Shows the six residual joins, their
cost expressions after dominance, the reducer grids, and the skew
mitigation against plain Shares, ending with the distributed execution
path (``run_distributed``: one ``all_to_all_single`` per relation over a
``torch.distributed`` group).  Run alone, the group is this process's own:
NCCL on the card, gloo with ``--device cpu``; under ``torchrun`` it is the
launcher's default group.  ``--device`` defaults to ``cuda`` and fails
without a card.

Run:  PYTHONPATH=src python examples/multiway_join_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import plan_plain_shares, plan_shares_skew, share_attributes, three_way_paper
from repro_torch.data import paper_3way
from repro_torch.mapreduce import oracle_join, run_distributed, run_join


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda", help="where the join runs (default: cuda)")
    args = parser.parse_args(argv)

    query = three_way_paper()
    print(f"query: {query}")
    print(f"share attributes after dominance: {share_attributes(query)}  "
          "(A dom. by B; D dom. by C; E dom. by B,C — paper Ex. 8)\n")

    rng = np.random.default_rng(0)
    data = paper_3way(rng, n=2_000, domain=20_000)

    plan = plan_shares_skew(query, data, q=120)
    print(plan.describe())
    print()

    res = run_join(query, data, plan, cap_factor=5.0, device=args.device)
    count, checksum, _, _ = oracle_join(query, data)
    assert (res.count, res.checksum) == (count, checksum)
    print(f"single-process engine: count={res.count} ✓ oracle  "
          f"max_load={res.max_load} imbalance={res.load_imbalance:.2f}")

    plain = plan_plain_shares(query, data, k=plan.total_reducers)
    res_plain = run_join(query, data, plain, cap_factor=200.0, device=args.device)
    print(f"plain Shares on the same skewed data: max_load={res_plain.max_load} "
          f"imbalance={res_plain.load_imbalance:.2f}  "
          f"(x{res_plain.max_load / max(res.max_load, 1):.1f} worse — Fig 3)")

    # distributed path: map, pack, all_to_all_single, bin and join a rank
    res_d = run_distributed(query, data, plan, cap_factor=5.0, device=args.device)
    assert (res_d.count, res_d.checksum) == (count, checksum)
    print(f"distributed engine (all_to_all shuffle): count={res_d.count} ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
