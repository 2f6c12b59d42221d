"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (taken for CPU tensors) and a launch counter.

  * ``reducer_join`` / ``flat_join`` — reduce-phase block equi-join
    (count + checksum), ``csrc/block_join.cu``
  * ``cms_update`` — Count-Min table increment, ``csrc/cms_update.cu``
  * ``fused_ingest_dense`` / ``fused_ingest`` — the streaming engine's fused
    ingest pass (destinations, pack plan, Count-Min increment),
    ``csrc/ingest_fused.cu`` beside ``csrc/cms_update.cu``
  * ``histogram.histogram`` — bincount of int32 values,
    ``csrc/histogram.cu``
  * ``flash_attention.flash_attention`` — attention forward with online
    softmax and GQA, ``csrc/flash_attention.cu``
  * ``wkv6.wkv6`` — the RWKV-6 wkv recurrence with its state carried in and
    out, ``csrc/wkv6.cu``

(The last three wrappers share their module's name, so the package exports
the modules under those names.)

Sources are compiled with nvcc at first use (``_build``), never at import.
"""
from . import block_join, flash_attention, histogram, ingest_fused, sketch_update, wkv6
from .block_join import block_join_ref, flat_join, reducer_join, tiled_join_ref
from .flash_attention import flash_attention_ref
from .histogram import histogram_ref
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
from .wkv6 import wkv6_ref

_MODULES = (block_join, sketch_update, ingest_fused, histogram, flash_attention, wkv6)


def launches() -> dict[str, int]:
    """Kernel launches counted by every wrapper, by wrapper name."""
    return {n: c for m in _MODULES for n, c in m.LAUNCHES.items()}


def reset_launches() -> None:
    for module in _MODULES:
        module.reset_launches()


__all__ = [
    "DenseRoutes",
    "block_join_ref",
    "cms_update",
    "cms_update_ref",
    "dense_route_encoding",
    "flash_attention_ref",
    "flat_join",
    "fused_ingest",
    "fused_ingest_dense",
    "fused_ingest_dense_ref",
    "fused_ingest_ref",
    "histogram_ref",
    "launches",
    "pack_routes",
    "reducer_join",
    "reset_launches",
    "route_width",
    "tiled_join_ref",
    "wkv6_ref",
]
