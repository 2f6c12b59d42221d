"""PyTorch MapReduce join engine: map-phase key generation, binning by
reducer, reduce-side join."""
from .executor import JoinResult, map_and_bin, measure_loads, predicted_comm, run_join
from .keys import RouteSpec, build_route_specs, map_phase
from .local_join import (
    LocalJoinSpec,
    binary_join_operands,
    group_by_reducer,
    local_join_count_checksum,
    materialize_two_way,
)
from .naive import NaiveStats, naive_two_way
from .oracle import groupby_oracle_two_way, oracle_join

__all__ = [
    "JoinResult",
    "LocalJoinSpec",
    "NaiveStats",
    "RouteSpec",
    "binary_join_operands",
    "build_route_specs",
    "group_by_reducer",
    "groupby_oracle_two_way",
    "local_join_count_checksum",
    "map_and_bin",
    "map_phase",
    "materialize_two_way",
    "measure_loads",
    "naive_two_way",
    "oracle_join",
    "predicted_comm",
    "run_join",
]
