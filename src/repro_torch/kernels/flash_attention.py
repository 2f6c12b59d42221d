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
with TMA loads for D = 64, 80 and 128 (so a head dim from 65 to 80, padded
to 80, takes wgmma too) and through mma.sync for the other head dims.  The
kernels run head dims that are multiples of 16 up to 256; the wrapper takes
any D in [1, 256] and runs a D that is not one at
``padded_head_dim(D)``, q, k and v zero-padded (``pad_head_dim``) and the
softmax scale kept at ``1 / sqrt(D)``: the zero columns add nothing to a
score and give output columns that are cropped, so the result is the
unpadded function's.  The kernels read q, k and v through their strides,
so the ``[B, L, H, D] -> [B, H, L, D]`` transpose of the attention layer is
not copied, and writes its output
as a ``[B, Lq, H, D]`` buffer seen as ``[B, H, Lq, D]``, so the layer's
transpose back is free too.

Gradients: ``flash_attention`` goes through ``FlashAttentionFn`` when grad
is enabled and q, k or v requires it.  On the card its forward is the same
kernel asked for each row's log-sum-exp as well (fp32 ``[B, H, Lq]``), and
its backward is ``flash_attention_bwd``: the kernels of
``csrc/flash_attention_bwd.cu`` (a key-tile kernel for dK and dV and a
query-tile kernel for dQ, chosen by ``bwd_kernel_variant``: wgmma and TMA
for bf16 at D = 64, 80 and 128; no atomics, so two calls give the same
bits).  On the CPU it runs ``flash_attention_ref_lse`` and
``flash_attention_bwd_ref``.  The JAX package has no backward kernel: it
differentiates its plain attention.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

MAX_HEAD_DIM = 256
_MASKED = -1e30  # the TPU kernel's finite mask value
_DTYPES = (torch.float32, torch.bfloat16)
# the kernels of csrc/flash_attention.cu, by the index its entry point takes
VARIANTS = ("fp32_cuda_cores", "bf16_mma_sync", "bf16_wgmma")
WGMMA_HEAD_DIMS = (64, 80, 128)
BWD_CHUNK = 128  # head-dim columns a backward block accumulates (csrc: DC_MAX)


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
    TMA for D = 64, 80 and 128, bf16 with mma.sync for the other D."""
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {d} must be a multiple of 16 in [16, {MAX_HEAD_DIM}]"
        )
    if dtype == torch.float32:
        return "fp32_cuda_cores"
    if dtype == torch.bfloat16:
        return "bf16_wgmma" if d in WGMMA_HEAD_DIMS else "bf16_mma_sync"
    raise TypeError(f"flash_attention: no kernel for {dtype}")


def bwd_kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The backward kernels for inputs of ``dtype`` with head dim ``d`` (a
    kernel's own): the forward's rule (``kernel_variant``), so that a
    training step's forward and backward take the same route.  fp32 on the
    CUDA cores; bf16 at D = 64, 80 and 128 with wgmma and TMA; bf16 at other D
    with mma.sync.  Each runs a key-tile kernel for dK and dV and a
    query-tile kernel for dQ, so every output has one owner."""
    return kernel_variant(dtype, d)


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' arithmetic type: fp32, or fp64 for fp64 inputs
    (``torch.autograd.gradcheck`` on the CPU)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _keep(lq: int, lk: int, device) -> torch.Tensor:
    """The start-aligned causal mask, [Lq, Lk]: key j kept for query i when j <= i."""
    return torch.arange(lq, device=device)[:, None] >= torch.arange(lk, device=device)


def flash_attention_ref_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the same function in fp32 with a materialised score
    matrix, any D; returns ([B, H, Lq, D] in q's dtype, each row's fp32
    log-sum-exp of its scaled scores [B, H, Lq]).  ``scale`` defaults to
    ``1 / sqrt(D)``."""
    h, hkv = q.shape[1], k.shape[1]
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kk = _wide(k).repeat_interleave(h // hkv, dim=1)
    vv = _wide(v).repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), kk) * scale
    if causal:
        s = torch.where(_keep(lq, lk, q.device), s, torch.full_like(s, _MASKED))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    total = p.sum(-1, keepdim=True)
    p = p / total
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return out, (m + torch.log(total))[..., 0]


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """``flash_attention_ref_lse``'s output alone: [B, H, Lq, D] in q's dtype."""
    return flash_attention_ref_lse(q, k, v, causal, scale)[0]


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward, in fp32 with materialised [Lq, Lk] matrices: from
    the forward's output ``o`` and row log-sum-exp ``lse`` and the output's
    gradient ``do``, (dq, dk, dv) in the inputs' dtypes.  P = exp(scale q
    k^T - lse), zero under the mask; dv = P^T do; dS = P (do v^T - delta)
    with delta = rowsum(do * o); dq = scale dS k; dk = scale dS^T q; dk and
    dv of a kv head sum over the query heads of its group."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, of, dof = _wide(q), _wide(o), _wide(do)
    kk = _wide(k).repeat_interleave(group, dim=1)
    vv = _wide(v).repeat_interleave(group, dim=1)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale - lse.to(qf.dtype)[..., None])
    if causal:
        p = torch.where(_keep(lq, lk, q.device), p, torch.zeros_like(p))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vv) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def per_kv_head(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, hkv, group, lk, d).sum(2)

    return dq.to(q.dtype), per_kv_head(dk).to(k.dtype), per_kv_head(dv).to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be [B, H, L, D]")
    # float64 only for the plain version on the CPU (gradcheck)
    dtypes = _DTYPES + ((torch.float64,) if q.device.type == "cpu" else ())
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
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


def _padded(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor zero-padded to the kernels' head dim and made readable."""
    dp = padded_head_dim(ts[0].shape[-1])
    return [_readable(pad_head_dim(t, dp)) for t in ts]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(q, k, v, causal: bool, d: int, with_lse: bool = False):
    """The forward kernel on the card on q, k, v already at a kernel's head
    dim (``_padded``), at the softmax scale of the true head dim ``d``;
    counts no launch.  Returns (out at the padded head dim, a ``[B, Lq, H,
    Dp]`` buffer seen as ``[B, H, Lq, Dp]``; fp32 ``[B, H, Lq]`` log-sum-exp
    or None)."""
    b, h, lq, dp = q.shape
    variant = kernel_variant(q.dtype, dp)
    hkv, lk = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H={b * h} exceeds the kernel's grid (65535)")
    out = torch.empty((b, lq, h, dp), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if with_lse else None
    if lq == 0 or b == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, VARIANTS.index(variant),
            b, h, hkv, lq, lk, dp, strides, 1.0 / math.sqrt(d), int(causal), _stream(q.device),
        )
    if err != 0:
        what = f"CUresult {err - 10000} for a tensor map" if err >= 10000 else f"cudaError {err}"
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: {what}")
    return out, lse


def bwd_chunk(dp: int) -> int:
    """Head-dim columns a backward block accumulates for head dim ``dp`` (a
    multiple of 16): ``dp`` split into the fewest chunks of at most
    ``BWD_CHUNK``, each rounded up to a multiple of 16."""
    n = -(-dp // BWD_CHUNK)
    per = -(-dp // n)
    return -(-per // 16) * 16


def _launch_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward kernels on the card, every tensor at a kernel's head dim
    and readable; counts no launch.  Returns (dq, dk, dv), each a ``[B, L,
    heads, Dp]`` buffer seen as ``[B, heads, L, Dp]``."""
    b, h, lq, dp = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H={b * h} exceeds the kernel's grid (65535)")
    variant = bwd_kernel_variant(q.dtype, dp)
    lse = lse.float().contiguous()
    dq = torch.empty((b, lq, h, dp), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, lk, hkv, dp), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, lk, hkv, dp), dtype=v.dtype, device=q.device).transpose(1, 2)
    if lq == 0 or b == 0:
        return dq, dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=q.device)
    lse2 = None
    pitch = lq
    if variant == "bf16_wgmma":  # rows padded to the dQ kernel's 128, lse * log2(e)
        pitch = -(-lq // 128) * 128
        lse2 = torch.empty((b, h, pitch), **f32)
    delta = torch.empty((b, h, pitch), **f32)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3])
    )
    fn = library("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None if lse2 is None else lse2.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), VARIANTS.index(variant),
            b, h, hkv, lq, lk, dp, bwd_chunk(dp), strides, scale, int(causal), _stream(q.device),
        )
    if err != 0:
        what = f"CUresult {err - 10000} for a tensor map" if err >= 10000 else f"cudaError {err}"
        raise RuntimeError(f"flash_attention_bwd {variant} kernel launch failed: {what}")
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashAttention backward: (dq, dk, dv) in the inputs' dtypes from the
    forward's inputs, its output ``o`` and row log-sum-exp ``lse`` and the
    output's gradient ``do``.  The kernels for CUDA tensors (any D in [1,
    256], run zero-padded and cropped), ``flash_attention_bwd_ref`` for CPU
    tensors."""
    _check(q, k, v, causal)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
            f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}"
        )
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (o.dtype == do.dtype == q.dtype):
        raise TypeError("flash_attention_bwd: o and do must have q's dtype")
    qp, kp, vp, op, dop = _padded(q, k, v, o, do)
    dq, dk, dv = _launch_bwd(qp, kp, vp, op, lse, dop, causal, scale)
    if q.numel():
        count_launch(LAUNCHES, "flash_attention_bwd")
    return dq[..., :d], dk[..., :d], dv[..., :d]


def _forward_lse(q, k, v, causal: bool):
    """The forward with each row's log-sum-exp, counted once where the
    kernel launches: (q, k, v, out, lse) at the kernels' padded head dim on
    the card (what a backward reads), the plain version's unpadded on the
    CPU."""
    if q.device.type == "cpu":
        out, lse = flash_attention_ref_lse(q, k, v, causal)
        return q, k, v, out, lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    qp, kp, vp = _padded(q, k, v)
    out, lse = _launch(qp, kp, vp, causal, q.shape[-1], with_lse=True)
    if out.numel():
        count_launch(LAUNCHES, "flash_attention")
    return qp, kp, vp, out, lse


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward and each query row's fp32 log-sum-exp ``[B, H, Lq]``:
    the kernel asked for both on the card (one launch), the plain version
    on the CPU.  No gradient: ``FlashAttentionFn`` is the differentiable
    call."""
    _check(q, k, v, causal)
    *_, out, lse = _forward_lse(q, k, v, causal)
    return out[..., :q.shape[-1]], lse


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient.  On the card: the forward kernel, asked
    for each row's log-sum-exp, and the backward kernels.  On the CPU:
    ``flash_attention_ref_lse`` and ``flash_attention_bwd_ref``.  It saves
    what the backward reads (q, k, v and the output at the kernels' padded
    head dim, the log-sum-exp), never the cropped view it returns."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        d = q.shape[-1]
        saved = _forward_lse(q, k, v, causal)
        ctx.save_for_backward(*saved)
        ctx.causal, ctx.d = causal, d
        out = saved[3]
        return out if out.shape[-1] == d else out[..., :d]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale = 1.0 / math.sqrt(ctx.d)
        if q.device.type != "cpu":  # q, k, v and o are padded: pad do to them
            do = pad_head_dim(do, q.shape[-1])
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(q.dtype), ctx.causal, scale)
        d = ctx.d
        return dq[..., :d], dk[..., :d], dv[..., :d], None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> torch.Tensor:
    """FlashAttention forward with grouped KV heads; [B, H, Lq, D] in q's
    dtype.  Differentiable (``FlashAttentionFn``) where grad is enabled and
    an input requires it; otherwise the forward alone."""
    _check(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    d = q.shape[-1]
    out, _ = _launch(*_padded(q, k, v), causal, d)
    if out.numel():
        count_launch(LAUNCHES, "flash_attention")
    return out[..., :d]
