"""Deterministic 32-bit mixing hashes shared by mapper key-gen and oracle.

The Shares algorithm requires one independent hash function per (residual
join, attribute) pair, identical across relations (§3: "independently
chosen random hash functions h_i, one for each attribute").  We derive a
32-bit seed from (residual_index, attribute) and use a murmur3-style
finalizer — implemented identically in numpy (planning/oracle) and torch
(mapper), so host and device agree bit-for-bit.

Torch has no logical shift or remainder on uint32, and int32 ``>>`` is
arithmetic, so the torch versions hold every 32-bit value as a non-negative
int64 below 2^32.  Products are split into 16-bit halves so no int64
intermediate overflows (``_mul32``).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def attr_seed(residual_index: int, attr: str) -> int:
    return zlib.crc32(f"{residual_index}/{attr}".encode()) & 0xFFFFFFFF


def mix32_np(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.astype(np.uint32) ^ np.uint32(seed)
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def bucket_np(x: np.ndarray, seed: int, dim: int) -> np.ndarray:
    return (mix32_np(x, seed) % np.uint32(dim)).astype(np.int32)


def row_weight_np(rows: np.ndarray, seed: int, mod: int = 251) -> np.ndarray:
    """Small per-tuple weight for orderless join checksums (host side)."""
    _check_mod(mod)
    acc = np.uint32(seed)
    h = np.full(rows.shape[0], acc, dtype=np.uint32)
    for j in range(rows.shape[1]):
        h = mix32_np(rows[:, j].astype(np.uint32) + h, seed + j + 1)
    return (h % np.uint32(mod)).astype(np.int32) + 1


def _check_mod(mod: int) -> None:
    # weight 0 marks an invalid slot in the reduce-side join (kernels.
    # block_join); h % mod + 1 is >= 1 only while mod >= 1
    if mod < 1:
        raise ValueError(f"row_weight needs mod >= 1, got {mod}")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits, in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32_torch(x: torch.Tensor, seed: int | torch.Tensor) -> torch.Tensor:
    """mix32 of the 32-bit pattern of ``x``; int64 result in [0, 2^32).
    ``seed`` is an int or an integer tensor that broadcasts against ``x``
    (one seed per element, by its 32-bit pattern)."""
    s = _u32(seed) if isinstance(seed, torch.Tensor) else int(seed) & _M32
    x = _u32(x) ^ s
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def bucket_torch(x: torch.Tensor, seed: int, dim: int) -> torch.Tensor:
    return (mix32_torch(x, seed) % int(dim)).to(torch.int32)


def row_weight_torch(rows: torch.Tensor, seed: int, mod: int = 251) -> torch.Tensor:
    """[N, arity] rows -> [N] int32 weights in [1, mod]; equals
    ``row_weight_np`` on the same rows."""
    _check_mod(mod)
    h = torch.full(
        (rows.shape[0],), int(seed) & _M32, dtype=torch.int64, device=rows.device
    )
    for j in range(rows.shape[1]):
        h = mix32_torch((_u32(rows[:, j]) + h) & _M32, seed + j + 1)
    return (h % int(mod)).to(torch.int32) + 1
