"""SharesSkew core: join schemas, share optimization, residual joins.

The paper's contribution (Afrati, Stasinopoulos, Ullman, Vassilakopoulos,
"SharesSkew: An Algorithm to Handle Skew for Joins in MapReduce", 2015)
as host-side numpy/scipy: ``plan_shares_skew`` produces the full plan that
``repro_torch.mapreduce`` executes with PyTorch.
"""
from .closed_forms import (
    chain_cost,
    chain_cost_equal_sizes,
    chain_shares,
    subchain_budgets,
    symmetric_cost,
    symmetric_cost_equal_sizes,
    symmetric_shares_equal_sizes,
    three_chain_cost,
    three_chain_shares,
    triangle_cost,
    triangle_shares,
    two_way_lower_bound,
    two_way_naive_cost,
    two_way_skew_cost,
    two_way_skew_shares,
)
from .cost import CostExpression
from .dominance import dominated_attributes, share_attributes
from .heavy_hitters import CountMinSketch, HeavyHitters, exact_heavy_hitters
from .planner import (
    ResidualPlan,
    SharesSkewPlan,
    plan_from_arrays,
    plan_plain_shares,
    plan_shares_skew,
    plan_to_arrays,
    plan_with_hh,
)
from .residual import (
    Combination,
    ORDINARY,
    detect_heavy_hitters,
    enumerate_combinations,
    prune_by_subsumption,
    relevant_mask,
    relevant_sizes,
)
from .schema import (
    JoinQuery,
    RelationSchema,
    chain_join,
    cycle_join,
    make_query,
    star_join,
    symmetric_join,
    three_way_paper,
    triangle,
    two_way,
)
from .shares import SharesSolution, solve_k_for_capacity, solve_shares

__all__ = [
    "CostExpression",
    "Combination",
    "CountMinSketch",
    "HeavyHitters",
    "JoinQuery",
    "ORDINARY",
    "RelationSchema",
    "ResidualPlan",
    "SharesSkewPlan",
    "SharesSolution",
    "chain_cost",
    "chain_cost_equal_sizes",
    "chain_join",
    "chain_shares",
    "cycle_join",
    "detect_heavy_hitters",
    "dominated_attributes",
    "enumerate_combinations",
    "exact_heavy_hitters",
    "make_query",
    "plan_from_arrays",
    "plan_plain_shares",
    "plan_shares_skew",
    "plan_to_arrays",
    "plan_with_hh",
    "prune_by_subsumption",
    "relevant_mask",
    "relevant_sizes",
    "share_attributes",
    "solve_k_for_capacity",
    "solve_shares",
    "star_join",
    "subchain_budgets",
    "symmetric_cost",
    "symmetric_cost_equal_sizes",
    "symmetric_join",
    "symmetric_shares_equal_sizes",
    "three_chain_cost",
    "three_chain_shares",
    "three_way_paper",
    "triangle",
    "triangle_cost",
    "triangle_shares",
    "two_way",
    "two_way_lower_bound",
    "two_way_naive_cost",
    "two_way_skew_cost",
    "two_way_skew_shares",
]
