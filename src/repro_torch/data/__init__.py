"""Data substrate: synthetic relations (paper workloads)."""
from .relations import (
    paper_2way,
    paper_3way,
    random_join_data,
    skewed_column,
    uniform_relation,
    zipf_column,
)

__all__ = [
    "paper_2way",
    "paper_3way",
    "random_join_data",
    "skewed_column",
    "uniform_relation",
    "zipf_column",
]
