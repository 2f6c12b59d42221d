"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (taken for CPU tensors) and a launch counter.

  * ``reducer_join`` / ``flat_join`` — reduce-phase block equi-join
    (count + checksum), ``csrc/block_join.cu``

Sources are compiled with nvcc at first use (``_build``), never at import.
"""
from .block_join import (
    LAUNCHES,
    block_join_ref,
    flat_join,
    reducer_join,
    reset_launches,
    tiled_join_ref,
)

__all__ = [
    "LAUNCHES",
    "block_join_ref",
    "flat_join",
    "reducer_join",
    "reset_launches",
    "tiled_join_ref",
]
