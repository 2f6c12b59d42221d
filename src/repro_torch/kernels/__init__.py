"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (taken for CPU tensors) and a launch counter.

  * ``reducer_join`` / ``flat_join`` — reduce-phase block equi-join
    (count + checksum), ``csrc/block_join.cu``
  * ``cms_update`` — Count-Min table increment, ``csrc/cms_update.cu``
  * ``fused_ingest_dense`` / ``fused_ingest`` — the streaming engine's fused
    ingest pass (destinations, pack plan, Count-Min increment),
    ``csrc/ingest_fused.cu`` beside ``csrc/cms_update.cu``

Sources are compiled with nvcc at first use (``_build``), never at import.
"""
from . import block_join, ingest_fused, sketch_update
from .block_join import block_join_ref, flat_join, reducer_join, tiled_join_ref
from .ingest_fused import (
    DenseRoutes,
    dense_route_encoding,
    fused_ingest,
    fused_ingest_dense,
    fused_ingest_dense_ref,
    fused_ingest_ref,
    pack_routes,
    route_width,
)
from .sketch_update import cms_update, cms_update_ref


def launches() -> dict[str, int]:
    """Kernel launches counted by every wrapper, by wrapper name."""
    return {**block_join.LAUNCHES, **sketch_update.LAUNCHES, **ingest_fused.LAUNCHES}


def reset_launches() -> None:
    for module in (block_join, sketch_update, ingest_fused):
        module.reset_launches()


__all__ = [
    "DenseRoutes",
    "block_join_ref",
    "cms_update",
    "cms_update_ref",
    "dense_route_encoding",
    "flat_join",
    "fused_ingest",
    "fused_ingest_dense",
    "fused_ingest_dense_ref",
    "fused_ingest_ref",
    "launches",
    "pack_routes",
    "reducer_join",
    "reset_launches",
    "route_width",
    "tiled_join_ref",
]
