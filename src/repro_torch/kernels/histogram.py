"""Histogram (bincount): CUDA kernel and its plain PyTorch version.

For int32 ``values [N]``, the ``[num_bins]`` int32 counts of each value in
``[0, num_bins)``.  Negative values and values ``>= num_bins`` are dropped:
that is what ``repro.kernels.histogram.histogram_pallas`` computes, since its
one-hot is taken against ``iota [0, num_bins)``.  (The JAX package's jnp
oracle ``histogram_ref`` clips values ``>= num_bins`` into the last bin
instead; the port follows the kernel.)

``histogram`` takes the hand-written CUDA kernels (``csrc/histogram.cu``)
for CUDA tensors and the plain ``histogram_ref`` for CPU tensors; a CUDA
tensor never falls back to the plain version.  Each value is read once: a
range that fits a CTA's shared memory is counted there, a wider one goes
straight to the output with device atomics, the values that repeat inside a
CTA folded in a small table of tagged slots.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"histogram": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def histogram_ref(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Plain version: [num_bins] int32 counts, out-of-range values dropped."""
    v = values.to(torch.int64)
    v = v[(v >= 0) & (v < num_bins)]
    out = torch.zeros(int(num_bins), dtype=torch.int64, device=values.device)
    out.index_add_(0, v, torch.ones_like(v))
    return out.to(torch.int32)


def _check(values: torch.Tensor, num_bins: int) -> None:
    if values.dtype != torch.int32:
        raise TypeError(f"histogram: values must be int32, got {values.dtype}")
    if values.dim() != 1:
        raise ValueError("histogram: values must be [N]")
    if not 1 <= int(num_bins) < 1 << 31:
        raise ValueError(f"histogram: num_bins must be in [1, 2^31), got {num_bins}")


def histogram(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """[num_bins] int32 counts of each value in [0, num_bins) over ``values``."""
    _check(values, num_bins)
    if values.device.type == "cpu":
        return histogram_ref(values, num_bins)
    if values.device.type != "cuda":
        raise ValueError(f"histogram: no kernel for device {values.device}")
    values = values.contiguous()
    out = torch.zeros(int(num_bins), dtype=torch.int32, device=values.device)
    if values.shape[0] == 0:
        return out
    fn = library("histogram").histogram_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), values.shape[0], int(num_bins), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {err}")
    count_launch(LAUNCHES, "histogram")
    return out
