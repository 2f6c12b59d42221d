"""FlashAttention forward: CUDA kernel and its plain PyTorch version.

For ``q [B, H, Lq, D]`` and ``k, v [B, Hkv, Lk, D]`` (fp32 or bf16), the
attention output ``[B, H, Lq, D]`` in q's dtype: softmax of ``q k^T / sqrt(D)``
over the keys (fp32 arithmetic whatever the input dtype), times v, with
query head h reading kv head ``h // (H // Hkv)``.  Under ``causal`` key j is
masked for query i when ``j > i``: the mask is aligned at position 0 on both
sides, as ``repro.kernels.flash_attention._flash_kernel`` does it, so the
wrapper takes causal attention only with ``Lq == Lk`` (where that alignment
and the end-aligned one of the jnp oracle agree) and raises otherwise.

``flash_attention`` takes the hand-written CUDA kernels
(``csrc/flash_attention.cu``) for CUDA tensors and the plain
``flash_attention_ref`` for CPU tensors; a CUDA tensor never falls back to
the plain version.  ``kernel_variant(dtype, d)`` chooses the kernel: fp32
inputs compute in fp32 on the CUDA cores; bf16 inputs on the tensor cores
(bf16 products, fp32 sums, p rounded to bf16 before P·V), through wgmma
with TMA loads for D = 64 and 128 and through mma.sync for the other head
dims.  The kernels run head dims that are multiples of 16 up to 256; the
wrapper takes any D in [1, 256] and runs a D that is not one at
``padded_head_dim(D)``, q, k and v zero-padded (``pad_head_dim``) and the
softmax scale kept at ``1 / sqrt(D)``: the zero columns add nothing to a
score and give output columns that are cropped, so the result is the
unpadded function's.  The kernels read q, k and v through their strides,
so the ``[B, L, H, D] -> [B, H, L, D]`` transpose of the attention layer is
not copied, and writes its output
as a ``[B, Lq, H, D]`` buffer seen as ``[B, H, Lq, D]``, so the layer's
transpose back is free too.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"flash_attention": 0}

MAX_HEAD_DIM = 256
_MASKED = -1e30  # the TPU kernel's finite mask value
_DTYPES = (torch.float32, torch.bfloat16)
# the kernels of csrc/flash_attention.cu, by the index its entry point takes
VARIANTS = ("fp32_cuda_cores", "bf16_mma_sync", "bf16_wgmma")
WGMMA_HEAD_DIMS = (64, 128)


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the next multiple of 16."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {d} outside [1, {MAX_HEAD_DIM}] (the kernels hold "
            f"fp32 tiles sized by D in shared memory and registers, up to {MAX_HEAD_DIM})"
        )
    return -(-d // 16) * 16


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t [..., D]`` zero-padded to ``[..., dp]`` in a new buffer; ``t``
    itself when D == dp."""
    d = t.shape[-1]
    if d == dp:
        return t
    out = torch.empty((*t.shape[:-1], dp), dtype=t.dtype, device=t.device)
    out[..., :d].copy_(t)
    out[..., d:].zero_()
    return out


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The kernel for inputs of ``dtype`` with head dim ``d`` (a kernel's
    own, a multiple of 16: see ``padded_head_dim``): fp32 on the CUDA cores
    (the fp32 parity path: full fp32 products, no TF32), bf16 with wgmma and
    TMA for D = 64 and 128, bf16 with mma.sync for the other D."""
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {d} must be a multiple of 16 in [16, {MAX_HEAD_DIM}]"
        )
    if dtype == torch.float32:
        return "fp32_cuda_cores"
    if dtype == torch.bfloat16:
        return "bf16_wgmma" if d in WGMMA_HEAD_DIMS else "bf16_mma_sync"
    raise TypeError(f"flash_attention: no kernel for {dtype}")


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version: the same function in fp32 with a materialised score
    matrix, any D; returns [B, H, Lq, D] in q's dtype.  ``scale`` defaults to
    ``1 / sqrt(D)``."""
    h, hkv = q.shape[1], k.shape[1]
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kk = k.float().repeat_interleave(h // hkv, dim=1)
    vv = v.float().repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        keep = torch.arange(lq, device=q.device)[:, None] >= torch.arange(lk, device=q.device)
        s = torch.where(keep, s, torch.full_like(s, _MASKED))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be [B, H, L, D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash_attention: q, k and v must all be float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must lie on one device")
    b, h, lq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )
    hkv, lk = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: H={h} is not a multiple of Hkv={hkv}")
    padded_head_dim(d)  # raises above the kernels' largest head dim
    if lk < 1:
        raise ValueError("flash_attention: needs at least one key")
    if causal and lq != lk:
        raise ValueError(
            f"flash_attention: causal attention needs Lq == Lk (got {lq}, {lk}): the "
            "kernel's mask is aligned at position 0, the oracle's at the end"
        )


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it, copied only where it cannot be: the
    head dimension contiguous and, for bf16 (16-byte loads), every stride a
    multiple of 8 elements and the base 16-byte aligned."""
    ok = t.stride(-1) == 1
    if t.dtype == torch.bfloat16:
        ok = ok and t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """The kernel on the card; counts no launch.  A head dim that is no
    multiple of 16 runs zero-padded and comes back cropped, a view of the
    padded output."""
    b, h, lq, d = q.shape
    dp = padded_head_dim(d)
    variant = kernel_variant(q.dtype, dp)
    hkv, lk = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H={b * h} exceeds the kernel's grid (65535)")
    q, k, v = (_readable(pad_head_dim(t, dp)) for t in (q, k, v))
    out = torch.empty((b, lq, h, dp), dtype=q.dtype, device=q.device).transpose(1, 2)
    if lq == 0 or b == 0:
        return out[..., :d]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), VARIANTS.index(variant),
            b, h, hkv, lq, lk, dp, strides, 1.0 / math.sqrt(d), int(causal), stream,
        )
    if err != 0:
        what = f"CUresult {err - 10000} for a tensor map" if err >= 10000 else f"cudaError {err}"
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: {what}")
    return out[..., :d]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> torch.Tensor:
    """FlashAttention forward with grouped KV heads; [B, H, Lq, D] in q's dtype."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = _launch(q, k, v, causal)
    if out.numel():
        count_launch(LAUNCHES, "flash_attention")
    return out
