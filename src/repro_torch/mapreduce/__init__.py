"""PyTorch MapReduce join engine: map-phase key generation, binning by
reducer, reduce-side join, speculative reduce shards, and the distributed
shuffle over ``torch.distributed``."""
from .executor import (
    JoinResult,
    map_and_bin,
    measure_loads,
    predicted_comm,
    run_join,
    run_join_speculative,
)
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
from .shuffle import run_distributed
from .straggler import (
    ChecksumMismatch,
    FailureDetector,
    SealedResult,
    ShardOutcome,
    run_with_speculation,
)

__all__ = [
    "ChecksumMismatch",
    "FailureDetector",
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
    "run_distributed",
    "run_join",
    "run_join_speculative",
    "run_with_speculation",
    "SealedResult",
    "ShardOutcome",
]
