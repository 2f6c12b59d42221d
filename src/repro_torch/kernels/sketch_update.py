"""Count-Min table increment: CUDA kernel and its plain PyTorch version.

For keys ``values [N]`` and one mix32 seed per sketch row, the
``[depth, width]`` int32 table whose entry (d, b) counts the keys with
``mix32(key, seeds[d]) % width == b`` — the bucket of
``repro_torch.mapreduce.hashing.bucket_np``, bit for bit, so a table made on
the card can be absorbed by a host sketch with the same seeds.

``cms_update`` takes the hand-written CUDA kernel (``csrc/cms_update.cu``)
for CUDA tensors and the plain ``cms_update_ref`` for CPU tensors; a CUDA
tensor never falls back to the plain version.  The kernel reads each key
once, counts it into every table of its column in shared memory, and merges
the tables of a thread-block cluster over distributed shared memory; where
one cluster covers every row (the library's ``cms_one_cluster_rows()``) it
stores the whole table, so the wrapper allocates it without zeroing it.
``cms_tables`` is the same kernel over several columns of a row block, the
sketch half of the fused ingest pass (``kernels.ingest_fused``); its
launches are counted by the fused wrapper that calls it, not in
``LAUNCHES["cms_update"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.mapreduce.hashing import bucket_torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"cms_update": 0}

_M32 = 0xFFFFFFFF


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def cms_update_ref(values: torch.Tensor, seeds, width: int) -> torch.Tensor:
    """Plain version: [depth, width] int32 bucket counts of ``values``."""
    out = torch.zeros((len(seeds), int(width)), dtype=torch.int32, device=values.device)
    for d, seed in enumerate(seeds):
        buckets = bucket_torch(values, seed, width).to(torch.int64)
        out[d] = torch.bincount(buckets, minlength=int(width)).to(torch.int32)
    return out


def cms_tables_ref(rows: torch.Tensor, cols, seeds, width: int) -> torch.Tensor:
    """Plain version of ``cms_tables``: [n_cols, depth, width] int32."""
    if not cols:
        return torch.zeros((0, len(seeds), int(width)), dtype=torch.int32, device=rows.device)
    return torch.stack([cms_update_ref(rows[:, c], seeds, width) for c in cols])


def _check(rows: torch.Tensor, cols, seeds, width: int) -> None:
    if rows.dtype != torch.int32:
        raise TypeError(f"cms: keys must be int32, got {rows.dtype}")
    if rows.dim() != 2:
        raise ValueError("cms: rows must be [N, arity]")
    if not seeds:
        raise ValueError("cms: needs at least one sketch-row seed")
    if not 1 <= int(width) < 1 << 31:
        raise ValueError(f"cms: width must be in [1, 2^31), got {width}")
    for c in cols:
        if not 0 <= int(c) < rows.shape[1]:
            raise ValueError(f"cms: column {c} outside the row's {rows.shape[1]} columns")


def _launch(rows: torch.Tensor, cols, seeds, width: int) -> torch.Tensor:
    """The kernel over ``rows [N, arity]`` (int32, contiguous, on the card):
    [n_cols, depth, width] int32.  Counts no launch."""
    shape = (len(cols), len(seeds), int(width))
    if rows.shape[0] == 0 or not cols:
        return torch.zeros(shape, dtype=torch.int32, device=rows.device)
    lib = library("cms_update")
    if len(cols) > lib.cms_max_cols() or len(seeds) > lib.cms_max_depth():
        raise ValueError(
            f"cms: {len(cols)} columns x {len(seeds)} seeds exceed the kernel's "
            f"{lib.cms_max_cols()} x {lib.cms_max_depth()}"
        )
    # one cluster stores every entry; otherwise the kernel adds into zeros
    stored = rows.shape[0] <= lib.cms_one_cluster_rows() and int(width) <= lib.cms_smem_words()
    out = (torch.empty if stored else torch.zeros)(shape, dtype=torch.int32, device=rows.device)
    fn = lib.cms_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint), ctypes.c_int, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    c_cols = (ctypes.c_int * len(cols))(*[int(c) for c in cols])
    c_seeds = (ctypes.c_uint * len(seeds))(*[int(s) & _M32 for s in seeds])
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(
            rows.data_ptr(), rows.shape[0], rows.shape[1], c_cols, len(cols),
            c_seeds, len(seeds), int(width), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"cms_update kernel launch failed: cudaError {err}")
    return out


def empty_launch(device) -> None:
    """Launch an empty kernel (one warp) on ``device``'s current stream: the
    launch floor that K4's time is read against (``chip_smoke.py``)."""
    fn = library("cms_update").cms_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


def cms_tables(rows: torch.Tensor, cols, seeds, width: int) -> torch.Tensor:
    """[n_cols, depth, width] int32: one Count-Min increment per column
    ``cols`` of ``rows [N, arity]``."""
    _check(rows, cols, seeds, width)
    if rows.device.type == "cpu":
        return cms_tables_ref(rows, cols, seeds, width)
    if rows.device.type != "cuda":
        raise ValueError(f"cms: no kernel for device {rows.device}")
    return _launch(rows.contiguous(), cols, seeds, width)


def cms_update(values: torch.Tensor, seeds, width: int) -> torch.Tensor:
    """[depth, width] int32 Count-Min increment for one batch of int32 keys."""
    if values.dim() != 1:
        raise ValueError("cms_update: values must be [N]")
    rows = values[:, None]
    _check(rows, (0,), seeds, width)
    if values.device.type == "cpu":
        return cms_update_ref(values, seeds, width)
    if values.device.type != "cuda":
        raise ValueError(f"cms_update: no kernel for device {values.device}")
    out = _launch(rows.contiguous(), (0,), seeds, width)[0]
    if values.shape[0]:
        count_launch(LAUNCHES, "cms_update")
    return out
