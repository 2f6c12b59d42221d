"""Data substrate: synthetic relations (paper workloads) + LM token pipeline."""
from .pipeline import TokenPipeline
from .relations import (
    paper_2way,
    paper_3way,
    random_join_data,
    skewed_column,
    uniform_relation,
    zipf_column,
)

__all__ = [
    "TokenPipeline",
    "paper_2way",
    "paper_3way",
    "random_join_data",
    "skewed_column",
    "uniform_relation",
    "zipf_column",
]
