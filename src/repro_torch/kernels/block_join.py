"""Reduce-phase block equi-join (count + checksum): CUDA kernel and its plain
PyTorch version.

For each reducer k, over R's and S's bins ``[K, cap, C]`` with weights
``[K, cap]``: the number of pairs equal on all C key columns with both
weights > 0, and the checksum sum(w_r * w_s) over those pairs with int32
wraparound (mod 2^32).  Weight 0 marks an invalid (padding) slot; valid
tuples carry weight >= 1 (``repro_torch.mapreduce.hashing.row_weight_torch``).

``reducer_join`` / ``flat_join`` take the hand-written CUDA kernel
(``csrc/block_join.cu``, an aggregate-by-key hash join whose R chunks
``chunk_geometry`` sizes) for CUDA tensors and the plain versions
``block_join_ref`` / ``tiled_join_ref`` for CPU tensors; a CUDA tensor never
falls back to the plain version.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"reducer_join": 0, "flat_join": 0}

PAIR_LIMIT = 1 << 31  # per-reducer count must stay below 2^31
_REF_CHUNK = 1 << 24  # pairs per step of the plain version
_SMEM = 72 * 1024  # shared memory a block of the kernel aims for: three an SM


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (mod 2^32)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def block_join_ref(
    r_keys: torch.Tensor,  # [K, cap_r, C]
    r_weights: torch.Tensor,  # [K, cap_r]
    s_keys: torch.Tensor,  # [K, cap_s, C]
    s_weights: torch.Tensor,  # [K, cap_s]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: per-reducer counts [K] and checksums [K], int32.

    The dense [K, cap_r, cap_s] equality, taken in slices of reducers and R
    rows so memory stays bounded."""
    k, cap_r, n_cols = r_keys.shape
    cap_s = s_keys.shape[1]
    cnt = torch.zeros(k, dtype=torch.int64, device=r_keys.device)
    chk = torch.zeros(k, dtype=torch.int64, device=r_keys.device)
    if k == 0 or cap_r == 0 or cap_s == 0:
        return cnt.to(torch.int32), chk.to(torch.int32)
    per_k = cap_r * cap_s
    k_step = max(1, _REF_CHUNK // per_k)
    r_step = cap_r if k_step > 1 else max(1, _REF_CHUNK // cap_s)
    s_ok = s_weights > 0
    s_w = s_weights.to(torch.int64)
    for k0 in range(0, k, k_step):
        ks = slice(k0, k0 + k_step)
        for r0 in range(0, cap_r, r_step):
            rs = slice(r0, r0 + r_step)
            eq = (r_weights[ks, rs] > 0)[:, :, None] & s_ok[ks, None, :]
            for c in range(n_cols):
                eq &= r_keys[ks, rs, c][:, :, None] == s_keys[ks, :, c][:, None, :]
            cnt[ks] += eq.sum(dim=(1, 2))
            prod = r_weights[ks, rs].to(torch.int64)[:, :, None] * s_w[ks, None, :]
            prod = torch.where(eq, prod & 0xFFFFFFFF, 0)
            chk[ks] = (chk[ks] + prod.sum(dim=(1, 2))) & 0xFFFFFFFF
    return cnt.to(torch.int32), _wrap_i32(chk)


def tiled_join_ref(
    r_keys: torch.Tensor, r_weights: torch.Tensor,
    s_keys: torch.Tensor, s_weights: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flat join: int32 scalars (count, checksum)."""
    cnt, chk = block_join_ref(
        r_keys[None], r_weights[None], s_keys[None], s_weights[None]
    )
    return cnt[0], chk[0]


def _check(r_keys, r_weights, s_keys, s_weights) -> None:
    ts = (r_keys, r_weights, s_keys, s_weights)
    if len({t.device for t in ts}) != 1:
        raise ValueError("block_join: all operands must be on one device")
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"block_join: operands must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("block_join: operands must be contiguous")
    if r_keys.dim() != 3 or s_keys.dim() != 3:
        raise ValueError("block_join: keys must be [K, cap, C]")
    k, cap_r, c = r_keys.shape
    if s_keys.shape[0] != k or s_keys.shape[2] != c:
        raise ValueError(f"block_join: key shapes differ: {tuple(r_keys.shape)} vs {tuple(s_keys.shape)}")
    if tuple(r_weights.shape) != (k, cap_r) or tuple(s_weights.shape) != (k, s_keys.shape[1]):
        raise ValueError("block_join: weights must be [K, cap] beside their keys")
    if cap_r * s_keys.shape[1] >= PAIR_LIMIT:
        raise ValueError(
            f"block_join: cap_r * cap_s = {cap_r * s_keys.shape[1]} >= 2^31, "
            "a per-reducer count could overflow"
        )


def chunk_geometry(cap_r: int, c: int) -> tuple[int, int]:
    """(chunk, slots) of the kernel for R bins of ``cap_r`` rows and keys of
    ``c`` columns: R rows a block and the size of its hash table, a power
    of two above ``chunk``.  A block holds ``slots`` table entries of three
    words and ``chunk`` rows of ``c + 1`` words in ``_SMEM`` bytes of shared
    memory; the chunk is the largest that fits, or all of ``cap_r``."""
    best, slots = 0, 2
    while 12 * slots < _SMEM:
        best = max(best, min(slots - 1, (_SMEM - 12 * slots) // (4 * (c + 1))))
        slots *= 2
    if best < 1:
        raise ValueError(
            f"block_join: a key of {c} columns does not fit in the kernel's "
            f"{_SMEM} bytes of shared memory a block"
        )
    chunk = max(1, min(cap_r, best))
    return chunk, 1 << chunk.bit_length()


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, typed once."""
    fn = library("block_join").block_join_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, r_keys, r_weights, s_keys, s_weights) -> tuple[torch.Tensor, torch.Tensor]:
    k, cap_r, c = r_keys.shape
    cap_s = s_keys.shape[1]
    out = torch.zeros((2, k), dtype=torch.int32, device=r_keys.device)  # cnt, chk
    if k == 0 or cap_r == 0 or cap_s == 0:
        return out[0], out[1]
    chunk, slots = chunk_geometry(cap_r, c)
    if k * -(-cap_r // chunk) >= 1 << 31:
        raise ValueError(f"block_join: shape {(k, cap_r, cap_s)} exceeds the launch grid")
    with torch.cuda.device(r_keys.device):
        stream = torch.cuda.current_stream(r_keys.device).cuda_stream
        err = _entry()(
            r_keys.data_ptr(), r_weights.data_ptr(), s_keys.data_ptr(),
            s_weights.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            k, cap_r, cap_s, c, chunk, slots, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    count_launch(LAUNCHES, name)
    return out[0], out[1]


def reducer_join(
    r_keys: torch.Tensor,  # [K, cap_r, C] int32
    r_weights: torch.Tensor,  # [K, cap_r] int32 (0 = invalid slot)
    s_keys: torch.Tensor,  # [K, cap_s, C] int32
    s_weights: torch.Tensor,  # [K, cap_s] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-reducer match counts [K] and checksums [K] (int32 wraparound)."""
    _check(r_keys, r_weights, s_keys, s_weights)
    if r_keys.device.type == "cpu":
        return block_join_ref(r_keys, r_weights, s_keys, s_weights)
    if r_keys.device.type != "cuda":
        raise ValueError(f"reducer_join: no kernel for device {r_keys.device}")
    return _launch("reducer_join", r_keys, r_weights, s_keys, s_weights)


def flat_join(
    r_keys: torch.Tensor,  # [N, C] int32
    r_weights: torch.Tensor,  # [N] int32
    s_keys: torch.Tensor,  # [M, C] int32
    s_weights: torch.Tensor,  # [M] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single flat join: int32 scalars (count, checksum) — the K = 1 launch
    of the block-join kernel, its grid over the chunks of R."""
    args = (r_keys[None], r_weights[None], s_keys[None], s_weights[None])
    _check(*args)
    if r_keys.device.type == "cpu":
        return tiled_join_ref(r_keys, r_weights, s_keys, s_weights)
    if r_keys.device.type != "cuda":
        raise ValueError(f"flat_join: no kernel for device {r_keys.device}")
    cnt, chk = _launch("flat_join", *args)
    return cnt[0], chk[0]
