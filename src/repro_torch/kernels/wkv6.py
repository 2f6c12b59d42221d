"""RWKV-6 wkv recurrence: CUDA kernel and its plain PyTorch version.

For r, k, v, w ``[B, L, H, hd]``, the bonus ``u [H, hd]`` and an optional
initial state ``s0 [B, H, hd, hd]`` (zero when omitted), per (b, h) and
token t::

    y_t = r_t · (S + u ∘ (k_t ⊗ v_t));   S <- diag(w_t) S + k_t ⊗ v_t

returning ``(y [B, L, H, hd], S_final [B, H, hd, hd])``.  r, k, v, w and
u may be fp32, bf16 or fp16: they are widened to fp32, the recurrence runs
in fp32, and y comes back in r's dtype, as ``wkv6_pallas`` returns it; the
state is fp32 in and out.  From zero it is
``repro.kernels.wkv6.wkv6_pallas``'s function; with a state it is what the
model's ``repro.models.rwkv6._wkv_scan`` takes and returns, in the same
layout, so ``time_mix`` needs no transpose and ``u`` is indexed by head
rather than broadcast to ``[B*H, hd]``.

``wkv6`` takes the hand-written CUDA kernel (``csrc/wkv6.cu``) for CUDA
tensors and the plain ``wkv6_ref`` for CPU tensors; a CUDA tensor never
falls back to the plain version.  The kernel has no backward yet: on the
card ``wkv6`` refuses inputs that require grad while grad is enabled
(training RWKV-6 there waits for ROADMAP queue 1, item 20); the plain
version differentiates.  The kernel reads r, k, v and w through
their strides (the reshapes of ``time_mix``'s projections are not copied)
and takes any ``L >= 1``.  It splits each (b, h) over ``hd / JC`` blocks of
JC state columns and, inside a block, gives each thread C columns of
``hd / P`` rows, one geometry a head dim (``launch_geometry(hd, L)`` names
it); a decode step (``L == 1``) takes a kernel of its own.  The kernel is
compiled for the head dims ``HEAD_DIMS``, multiples of 16 up to 128; any
hd in [1, 128] runs at ``padded_head_dim(hd)``, its inputs zero-padded by
``pad_head_dim`` (w by ones) and y and the state cropped: a padded row has
r = k = 0 and a zero state, a padded column v = 0 and a zero state, so both
stay zero and add nothing to the true sums.  ``state_out``,
when given, is a contiguous buffer that receives the final state and may be
``s0`` itself: a decode step updates its state in place.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"wkv6": 0}

# dtypes r, k, v, w and u may have; the state is fp32
INPUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
# (JC, P, C) of each head dim, as csrc/wkv6.cu's wkv6_launch instantiates
# them: JC state columns a block, P threads (adjacent lanes) share a group of
# C columns, each holding hd / P of its rows.
_GEOMETRY = {16: (16, 4, 2), 32: (32, 8, 4), 48: (16, 4, 2), 64: (16, 16, 4),
             80: (16, 4, 2), 96: (32, 8, 4), 112: (16, 4, 2), 128: (32, 16, 4)}
STEP = (0, 0, 0)  # the decode step's kernel
MAX_HEAD_DIM = HEAD_DIMS[-1]


def padded_head_dim(hd: int) -> int:
    """The head dim of ``HEAD_DIMS`` that the kernel runs ``hd`` at: the
    next multiple of 16."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"wkv6: head dim {hd} outside [1, {MAX_HEAD_DIM}] (the kernel holds the fp32 "
            f"state and a tile's rows, sized by hd, in registers and shared memory)"
        )
    return -(-hd // 16) * 16


def launch_geometry(hd: int, l: int = 2) -> tuple[int, int, int]:
    """(JC, P, C) that csrc/wkv6.cu launches for head dim ``hd`` over ``l``
    tokens, the geometry of ``padded_head_dim(hd)``: blocks of JC state
    columns (hd / JC blocks a head), each column's rows split over P threads
    in adjacent lanes, each thread holding C columns of hd / P rows; whole
    warps a block.  At rwkv6-3b's hd = 64: (16, 16, 4), the fastest of five
    geometries timed on the card (PERF.md).  A decode step (``l == 1``) has
    no sequence to pipeline: (0, 0, 0) names the kernel for it, one block of
    hd threads a head."""
    hp = padded_head_dim(hd)
    if l < 1:
        raise ValueError("wkv6: needs at least one token")
    return STEP if l == 1 else _GEOMETRY[hp]


def pad_head_dim(r, k, v, w, u, s0=None):
    """(r, k, v, w, u, s0) at ``padded_head_dim(hd)``, in new fp32 buffers:
    r, k, v and u padded with zeros, w with ones (any finite decay: it only
    scales a zero row), s0 with zeros (None stays None).  The inputs
    themselves when hd is already a kernel's."""
    hd = r.shape[-1]
    hp = padded_head_dim(hd)
    if hp == hd:
        return r, k, v, w, u, s0

    def pad(t, fill, lead):
        out = torch.empty((*t.shape[:lead], *(hp,) * (t.dim() - lead)), dtype=torch.float32,
                          device=t.device)
        out.fill_(fill)
        out[(...,) + (slice(0, hd),) * (t.dim() - lead)].copy_(t)
        return out

    r, k, v, u = (pad(t, 0.0, t.dim() - 1) for t in (r, k, v, u))
    w = pad(w, 1.0, w.dim() - 1)
    return r, k, v, w, u, None if s0 is None else pad(s0, 0.0, 2)


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def wkv6_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    s0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: a loop over t with the state carried, in fp32, in the
    order of the JAX package's scan; returns (y in r's dtype, final fp32
    state)."""
    b, l, h, hd = r.shape
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) if s0 is None \
        else s0.float()
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(l):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t].float(), s + uu * kv))
        s = w[:, t].float()[..., :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def _check(r, k, v, w, u, s0, state_out) -> None:
    if any(t.dim() != 4 for t in (r, k, v, w)):
        raise ValueError("wkv6: r, k, v and w must be [B, L, H, hd]")
    if not r.shape == k.shape == v.shape == w.shape:
        raise ValueError(
            f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} and "
            f"w {tuple(w.shape)} differ"
        )
    b, l, h, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv6: u must be [H, hd] = {(h, hd)}, got {tuple(u.shape)}")
    for name, s in (("s0", s0), ("state_out", state_out)):
        if s is not None and s.shape != (b, h, hd, hd):
            raise ValueError(
                f"wkv6: {name} must be [B, H, hd, hd] = {(b, h, hd, hd)}, got {tuple(s.shape)}"
            )
    if state_out is not None and not state_out.is_contiguous():
        raise ValueError("wkv6: state_out must be contiguous (it is written in place)")
    if any(t.dtype not in INPUT_DTYPES for t in (r, k, v, w, u)):
        raise TypeError(
            "wkv6: r, k, v, w and u must be float32, bfloat16 or float16, got "
            + ", ".join(str(t.dtype) for t in (r, k, v, w, u))
        )
    states = [t for t in (s0, state_out) if t is not None]
    if any(t.dtype != torch.float32 for t in states):
        raise TypeError(
            "wkv6: the state must be float32, got " + ", ".join(str(t.dtype) for t in states)
        )
    given = [t for t in (r, k, v, w, u, s0, state_out) if t is not None]
    if any(t.device != r.device for t in given):
        raise ValueError("wkv6: every input must lie on one device")
    padded_head_dim(hd)  # raises above the kernels' largest head dim
    if l < 1:
        raise ValueError("wkv6: needs at least one token")


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it (16-byte copies), copied only where it
    cannot be: the last dimension contiguous, the other strides multiples of
    4 elements and the base 16-byte aligned."""
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0
    ok = ok and all(st % 4 == 0 for st in t.stride()[:3])
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _launch(r, k, v, w, u, s0, state_out) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the card; counts no launch.  The kernel reads fp32:
    narrower inputs are widened here, and y narrowed to r's dtype after.  A
    head dim that is no kernel's runs padded (``pad_head_dim``); y and the
    state come back cropped, the state into ``state_out`` when given."""
    b, l, h, hd = r.shape
    out_dtype = r.dtype
    r, k, v, w, u, s0 = pad_head_dim(r, k, v, w, u, s0)
    hp = r.shape[-1]
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    r, k, v, w = (_readable(t) for t in (r, k, v, w))
    u = u if u.is_contiguous() and u.data_ptr() % 16 == 0 else u.clone(
        memory_format=torch.contiguous_format)
    if s0 is not None:
        s0 = s0.contiguous()
    s_out = state_out if hp == hd else None
    if s_out is None:
        s_out = torch.empty((b, h, hp, hp), dtype=torch.float32, device=r.device)
    y = torch.empty((b, l, h, hp), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (r, k, v, w) for s in t.stride()[:3]))
    fn = library("wkv6").wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            b, l, h, hp, strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err}")
    if hp != hd:
        y, s_out = y[..., :hd], s_out[:, :, :hd, :hd]
        s_out = s_out.contiguous() if state_out is None else state_out.copy_(s_out)
    return y.to(out_dtype), s_out


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    s0: torch.Tensor | None = None, state_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence over ``[B, L, H, hd]``; returns (y, final state),
    the final state written into ``state_out`` when it is given."""
    _check(r, k, v, w, u, s0, state_out)
    if r.device.type == "cpu":
        y, s = wkv6_ref(r, k, v, w, u, s0)
        if state_out is not None:
            s = state_out.copy_(s)
        return y, s
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0)
    ):
        raise RuntimeError(
            "wkv6: the CUDA kernel has no backward yet (ROADMAP queue 1, item 20), so its "
            "output would carry no gradient to r, k, v, w, u or s0; call it under "
            "torch.no_grad(), or on CPU tensors, whose plain version differentiates"
        )
    out = _launch(r, k, v, w, u, s0, state_out)
    count_launch(LAUNCHES, "wkv6")
    return out
