"""RWKV-6 wkv recurrence: CUDA kernels (forward K7, backward K7b) and their
plain PyTorch versions.

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
falls back to the plain version.  Where grad is enabled and an input
requires it, ``wkv6`` goes through ``Wkv6Fn``, whose backward is K7b
(``wkv6_bwd``, ``csrc/wkv6_bwd.cu``) on the card and ``wkv6_bwd_ref``, an
explicit reverse recurrence, on the CPU: the gradients of r, k, v, w, u
and s0 from those of y and of the final state.  The kernel reads r, k, v
and w through their strides (the reshapes of ``time_mix``'s projections
are not copied) and takes any ``L >= 1``.  It splits each (b, h) over ``hd / JC`` blocks of
JC state columns and, inside a block, gives each thread C columns of
``hd / P`` rows, one geometry a head dim (``launch_geometry(hd, L)`` names
it); a decode step (``L == 1``) takes a kernel of its own.  The kernel is
compiled for the head dims ``HEAD_DIMS``, multiples of 16 up to 128; any
hd in [1, 128] runs at ``padded_head_dim(hd)``, its inputs zero-padded by
``pad_head_dim`` (w by ones) and y and the state cropped: a padded row has
r = k = 0 and a zero state, a padded column v = 0 and a zero state, so both
stay zero and add nothing to the true sums.  K7b pads and crops the same
way, to ``bwd_head_dim(hd)``, the next power of two from 16 (its padded
rows and columns of dy and of the state's gradient are zeros, so the
gradient's recurrence keeps them zero too).  K7b cuts the sequence into
chunks of ``BWD_CHUNK`` tokens and runs them in parallel
(``wkv6_bwd_chunked_ref`` renders its passes in plain torch).  ``state_out``,
when given, is a contiguous buffer that receives the final state and may be
``s0`` itself: a decode step updates its state in place (never under a
gradient).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import count_launch, library, reset_counts

LAUNCHES = {"wkv6": 0, "wkv6_bwd": 0}

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
# K7b (csrc/wkv6_bwd.cu): its head dims, and the tokens of a chunk and of a
# tile of its pass C (the .cu's CH and T)
BWD_HEAD_DIMS = (16, 32, 64, 128)
BWD_CHUNK = 32
BWD_TILE = 8


def padded_head_dim(hd: int) -> int:
    """The head dim of ``HEAD_DIMS`` that the kernel runs ``hd`` at: the
    next multiple of 16."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"wkv6: head dim {hd} outside [1, {MAX_HEAD_DIM}] (the kernel holds the fp32 "
            f"state and a tile's rows, sized by hd, in registers and shared memory)"
        )
    return -(-hd // 16) * 16


def bwd_head_dim(hd: int) -> int:
    """The head dim of ``BWD_HEAD_DIMS`` that K7b runs ``hd`` at: the next
    power of two from 16 (a pass-C block holds 16 whole rows, hd / 4 adjacent
    lanes a row, and the rows' lanes meet by shuffles within a warp)."""
    padded_head_dim(hd)  # raises outside [1, MAX_HEAD_DIM]
    return next(x for x in BWD_HEAD_DIMS if x >= hd)


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


def pad_head_dim(r, k, v, w, u, s0=None, width=None):
    """(r, k, v, w, u, s0) at ``width`` (default ``padded_head_dim(hd)``),
    in new fp32 buffers: r, k, v and u padded with zeros, w with ones (any
    finite decay: it only scales a zero row), s0 with zeros (None stays
    None).  The inputs themselves when hd is already that width."""
    hd = r.shape[-1]
    hp = padded_head_dim(hd) if width is None else width
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
    """Plain version: a loop over t with the state carried, in fp32 (float64
    for float64 inputs, which only ``Wkv6Fn``'s gradcheck passes), in the
    order of the JAX package's scan; returns (y in r's dtype, final state)."""
    b, l, h, hd = r.shape
    acc = _acc(r)
    s = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device) if s0 is None else s0.to(acc)
    uu = u.to(acc)[None, :, :, None]
    ys = []
    for t in range(l):
        kv = k[:, t].to(acc)[..., :, None] * v[:, t].to(acc)[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t].to(acc), s + uu * kv))
        s = w[:, t].to(acc)[..., :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def _acc(r: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: fp32, or float64 for float64."""
    return torch.float64 if r.dtype == torch.float64 else torch.float32


def wkv6_bwd_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    dy: torch.Tensor, s0: torch.Tensor | None = None, ds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the backward: the states S_{t-1} by the forward
    recurrence, then, with G = dL/dS_t from ``ds`` (zero when omitted) and
    G_{t-1} = w_t ∘ G_t + r_t ⊗ dy_t, token by token from the last::

        dr_t = (S_{t-1} + u k_t ⊗ v_t) dy_t     dw_t = rowsum(G_t ∘ S_{t-1})
        dk_t = (G_t + r_t u ⊗ dy_t) v_t         dv_t = (G_t + r_t u ⊗ dy_t)ᵀ k_t
        du = Σ_{b,t} r_t k_t (v_t · dy_t)       ds0 = G_0

    in fp32 (float64 for float64 inputs).  Returns (dr, dk, dv, dw, du) in
    the dtypes of r, k, v, w, u, and ds0 in the working dtype."""
    b, l, h, hd = r.shape
    acc = _acc(r)
    rr, kk, vv, ww, gy = (t.to(acc) for t in (r, k, v, w, dy))
    uu = u.to(acc)
    s = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device) if s0 is None else s0.to(acc)
    before = []
    for t in range(l):
        before.append(s)
        s = ww[:, t, :, :, None] * s + kk[:, t, :, :, None] * vv[:, t, :, None, :]
    g = torch.zeros_like(s) if ds is None else ds.to(acc)
    dr, dk, dv, dw = (torch.empty_like(rr) for _ in range(4))
    du = torch.zeros_like(uu)
    for t in reversed(range(l)):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (rr, kk, vv, ww, gy))  # [B, H, hd]
        sp = before[t]
        dr[:, t] = ((sp + (uu * kt)[..., :, None] * vt[..., None, :]) * dyt[..., None, :]).sum(-1)
        gp = g + (rt * uu)[..., :, None] * dyt[..., None, :]
        dk[:, t] = (gp * vt[..., None, :]).sum(-1)
        dv[:, t] = (gp * kt[..., :, None]).sum(-2)
        dw[:, t] = (g * sp).sum(-1)
        du += (rt * kt * (vt * dyt).sum(-1, keepdim=True)).sum(0)
        g = wt[..., :, None] * g + rt[..., :, None] * dyt[..., None, :]
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype), g


def wkv6_bwd_chunked_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    dy: torch.Tensor, s0: torch.Tensor | None = None, ds: torch.Tensor | None = None,
    chunk: int = BWD_CHUNK, tile: int = BWD_TILE,
) -> tuple[torch.Tensor, ...]:
    """K7b's algorithm in plain torch, for the tests: ``wkv6_bwd_ref``'s
    function, the sequence cut into chunks of ``chunk`` tokens (the last
    padded with tokens that change nothing: r = k = v = dy = 0, w = 1).

    A. the state at each chunk's start, chunk after chunk: S_end = diag(P)
       S_start + K̃ᵀ V, K̃[s] = k_s ∘ Π_{s<τ≤end} w_τ, P the chunk's product
       of w;
    B. G at each chunk's end, the last chunk first: G_start-1 = diag(P)
       G_end + R̃ᵀ dY, R̃[t] = r_t ∘ Π_{start≤τ<t} w_τ; ds0 is G before the
       first token;
    C. every chunk at once from its S and G: a forward walk keeps the state
       before each tile of ``tile`` tokens, then a backward walk recomputes
       each tile's states and carries G through it.

    Decay products are formed by multiplying w, never by dividing by it.
    du adds each chunk's sum over b, then over the chunks, in that order.
    Returns what ``wkv6_bwd_ref`` returns."""
    b, l, h, hd = r.shape
    acc = _acc(r)
    nc = -(-l // chunk)
    pad = nc * chunk - l

    def chunks(t, fill):  # [B, L, H, hd] -> [nc, chunk, B, H, hd], padded
        t = t.to(acc)
        if pad:
            t = torch.cat([t, t.new_full((b, pad, h, hd), fill)], 1)
        return t.view(b, nc, chunk, h, hd).permute(1, 2, 0, 3, 4)

    rc, kc, vc, dc = (chunks(t, 0.0) for t in (r, k, v, dy))
    wc = chunks(w, 1.0)
    uu = u.to(acc)
    zero = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device)
    # A
    s = zero if s0 is None else s0.to(acc)
    starts = []
    for c in range(nc):
        starts.append(s)
        decay, kt = torch.ones_like(kc[c, 0]), torch.empty_like(kc[c])
        for t in reversed(range(chunk)):
            kt[t] = kc[c, t] * decay
            decay = decay * wc[c, t]
        s = decay[..., None] * s + torch.einsum("tbhi,tbhj->bhij", kt, vc[c])
    # B
    g = zero if ds is None else ds.to(acc)
    ends = [zero] * nc
    for c in reversed(range(nc)):
        ends[c] = g
        decay, rt = torch.ones_like(rc[c, 0]), torch.empty_like(rc[c])
        for t in range(chunk):
            rt[t] = rc[c, t] * decay
            decay = decay * wc[c, t]
        g = decay[..., None] * g + torch.einsum("tbhi,tbhj->bhij", rt, dc[c])
    ds0 = g
    # C: every chunk at once, [nc, B, H, hd, hd]
    def step(state, x):
        return wc[:, x, ..., None] * state + kc[:, x, ..., None] * vc[:, x, ..., None, :]

    s, g = torch.stack(starts), torch.stack(ends)
    snaps = []
    for x in range(chunk):
        if x % tile == 0:
            snaps.append(s)
        s = step(s, x)
    a = (vc * dc).sum(-1, keepdim=True)  # v_t . dy_t [nc, chunk, B, H, 1]
    dr, dk, dv, dw = (torch.empty_like(rc) for _ in range(4))
    for n in reversed(range(len(snaps))):
        s, before = snaps[n], []
        xs = range(n * tile, min((n + 1) * tile, chunk))
        for x in xs:
            before.append(s)
            s = step(s, x)
        for x, sp in zip(reversed(xs), reversed(before)):
            rt, kt, vt, wt, dyt, at = (t[:, x] for t in (rc, kc, vc, wc, dc, a))
            dr[:, x] = (sp * dyt[..., None, :]).sum(-1) + uu * kt * at
            dk[:, x] = (g * vt[..., None, :]).sum(-1) + rt * uu * at
            dv[:, x] = (g * kt[..., :, None]).sum(-2) + dyt * (rt * uu * kt).sum(-1, keepdim=True)
            dw[:, x] = (g * sp).sum(-1)
            g = wt[..., :, None] * g + rt[..., :, None] * dyt[..., None, :]
    du_part = (rc * kc * a).sum(1)  # [nc, B, H, hd]
    du = torch.zeros_like(uu)
    for bb in range(b):
        for c in range(nc):
            du = du + du_part[c, bb]

    def unchunk(t):
        return t.permute(2, 0, 1, 3, 4).reshape(b, nc * chunk, h, hd)[:, :l]

    dr, dk, dv, dw = map(unchunk, (dr, dk, dv, dw))
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype), ds0


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as fp32, contiguous and 16-byte aligned, copied only where it
    is not already."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(r, k, v, w, u, dy, s0, ds) -> tuple[torch.Tensor, ...]:
    """K7b on the card; counts no launch.  Inputs are widened to fp32 and,
    at a head dim that is not K7b's, padded to ``bwd_head_dim(hd)`` as the
    forward pads them (dy and ``ds`` with zeros); the gradients come back
    cropped, in the inputs' dtypes (ds0 fp32)."""
    b, l, h, hd = r.shape
    dtypes = (r.dtype, k.dtype, v.dtype, w.dtype, u.dtype)
    hp = bwd_head_dim(hd)
    r, k, v, w, u, s0 = pad_head_dim(r, k, v, w, u, s0, width=hp)
    if hp != hd:
        dy = torch.nn.functional.pad(dy.float(), (0, hp - hd))
        if ds is not None:
            ds = torch.nn.functional.pad(ds.float(), (0, hp - hd, 0, hp - hd))
    r, k, v, w, u, dy = (_aligned(t) for t in (r, k, v, w, u, dy))
    s0, ds = (None if t is None else _aligned(t) for t in (s0, ds))
    lib = library("wkv6_bwd")
    if lib.wkv6_bwd_chunk() != BWD_CHUNK:
        raise RuntimeError("wkv6_bwd: the library's chunk differs from BWD_CHUNK")
    nc = -(-l // BWD_CHUNK)
    dev = r.device
    f32 = dict(dtype=torch.float32, device=dev)
    sbuf = torch.empty((nc, b, h, hp, hp), **f32)
    gbuf = torch.empty((nc, b, h, hp, hp), **f32)
    du_part = torch.empty((b, nc, h, hp), **f32)
    grads = torch.empty((3, b, l, h, hp), **f32)
    dv = torch.empty((b, l, h, hp), **f32)
    du = torch.empty((h, hp), **f32)
    ds0 = torch.empty((b, h, hp, hp), **f32)
    fn = lib.wkv6_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(ptr(t) for t in (r, k, v, w, u, dy, s0, ds, sbuf, gbuf, du_part, grads, dv,
                                    du, ds0)), b, l, h, hp, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: cudaError {err}")
    del sbuf, gbuf, du_part
    dr, dk, dw = grads.unbind(0)
    out = [dr, dk, dv, dw, du]
    if hp != hd:
        out = [t[..., :hd] for t in out]
        ds0 = ds0[:, :, :hd, :hd]
    return (*(t.to(dt) for t, dt in zip(out, dtypes)), ds0.contiguous())


def wkv6_bwd(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    dy: torch.Tensor, s0: torch.Tensor | None = None, ds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The backward of ``wkv6``: from the forward's inputs, the gradient
    ``dy`` of y and ``ds`` of the final state (zero when omitted), returns
    (dr, dk, dv, dw, du) in the dtypes of r, k, v, w, u and ds0 (fp32): K7b
    for CUDA tensors, ``wkv6_bwd_ref`` for CPU tensors."""
    _check(r, k, v, w, u, s0, None)
    b, _, h, hd = r.shape
    if dy.shape != r.shape:
        raise ValueError(f"wkv6_bwd: dy must be {tuple(r.shape)}, got {tuple(dy.shape)}")
    if ds is not None and ds.shape != (b, h, hd, hd):
        raise ValueError(f"wkv6_bwd: ds must be {(b, h, hd, hd)}, got {tuple(ds.shape)}")
    if dy.dtype not in INPUT_DTYPES or (ds is not None and ds.dtype != torch.float32):
        raise TypeError("wkv6_bwd: dy must be float32, bfloat16 or float16 and ds float32")
    if any(t is not None and t.device != r.device for t in (dy, ds)):
        raise ValueError("wkv6_bwd: every input must lie on one device")
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd: no kernel for device {r.device}")
    out = _launch_bwd(r, k, v, w, u, dy, s0, ds)
    count_launch(LAUNCHES, "wkv6_bwd")
    return out


class Wkv6Fn(torch.autograd.Function):
    """The recurrence with its gradient: K7 forward and K7b backward on the
    card, ``wkv6_ref`` and ``wkv6_bwd_ref`` on the CPU.  It saves the
    inputs only; K7b recomputes the states it needs.  The gradient of s0 is
    returned where s0 was given."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        if r.device.type == "cpu":
            y, s = wkv6_ref(r, k, v, w, u, s0)
        else:
            y, s = _launch(r, k, v, w, u, s0, None)
            count_launch(LAUNCHES, "wkv6")
        ctx.save_for_backward(r, k, v, w, u, s0)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        if r.device.type == "cpu":  # also float64, which only gradcheck passes
            grads = wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
        else:
            grads = wkv6_bwd(r, k, v, w, u, dy.to(r.dtype), s0, ds)
        *drkvwu, ds0 = grads
        return (*drkvwu, None if s0 is None else ds0.to(s0.dtype))


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    s0: torch.Tensor | None = None, state_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence over ``[B, L, H, hd]``; returns (y, final state),
    the final state written into ``state_out`` when it is given.
    Differentiable (``Wkv6Fn``) where grad is enabled and an input requires
    it; otherwise the forward alone."""
    _check(r, k, v, w, u, s0, state_out)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0)
    ):
        if state_out is not None:
            raise ValueError("wkv6: state_out is written in place and takes no gradient; "
                             "leave it out where a gradient is wanted")
        return Wkv6Fn.apply(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        y, s = wkv6_ref(r, k, v, w, u, s0)
        if state_out is not None:
            s = state_out.copy_(s)
        return y, s
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    out = _launch(r, k, v, w, u, s0, state_out)
    count_launch(LAUNCHES, "wkv6")
    return out
