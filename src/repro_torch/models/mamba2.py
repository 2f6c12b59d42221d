"""Mamba2 (SSD) blocks and the Zamba2 hybrid (zamba2-2.7b): the counterpart
of ``repro.models.mamba2``, forward, loss with gradients, and serving.

Mamba2 recurrence per head (state dim s, head dim p)::

    S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = S_t @ C_t + D_h * x_t

with scalar A per head, B and C shared across heads (ngroups = 1), a short
causal depthwise conv on the SSM input, and a gated RMSNorm on the output
(arXiv:2405.21060).  Zamba2 (arXiv:2411.15242) is a stack of Mamba2 blocks
with one *shared* attention-and-MLP block, the same parameters each time,
applied after every ``hybrid_period`` blocks.  Its attention is
``layers.attention``: FlashAttention (K6) on the card, and under a gradient
K6 with its backward kernel (K6b).

The recurrence runs in SSD's chunked matrix form (``ssd``), where the JAX
package runs a sequential ``lax.scan`` outside any Pallas kernel: within a
chunk of 64 tokens it is batched matrix products, and a loop over the
chunks carries the fp32 state.  A single token (decode) is the direct
update.

Parameters are a dict as in ``models.transformer``: ``blocks`` is a list of
per-layer dicts (the JAX package stacks them on axis 0), ``shared_attn`` one
block.  Weights are kept in the compute dtype, as the JAX package casts them
at use; ``A_log``, ``D`` and ``dt_bias`` stay float32 in every dtype, as the
JAX package computes with them in float32.  Not carried over: the
activation-sharding hook (``constrain_activations``, with ``launch/``) and
``REPRO_SSD_UNROLL``, which sets the unroll of XLA's scan.

Every function takes ``tp`` (``tensor_parallel.TensorParallel``; None: the
whole model on this rank), the counterpart of the JAX package's
``constrain_activations`` under ``--mesh prod``: a rank runs SSM heads
[h0, h1) (``tp.block(ssm_heads)``), each ``d_inner / ssm_heads`` channels,
as ``launch.sharding.param_specs`` places each leaf:

  * ``in_proj`` [d, 2 di + 2 s + H] is column-parallel, and its split cuts
    across the segments z, x, B, C and dt (zamba2-2.7b's 10,448 columns are
    5,224 a rank at model 2).  A rank needs its heads' z, x and dt columns
    and the whole B and C (one group: every head reads them), so it gathers
    ``in_proj`` whole in the compute dtype once a layer (53 MB in bf16 at
    full size) and takes those columns through
    ``copy`` (``tp.local``), its input through ``copy`` too.  A placement by
    segment is later work (ROADMAP).
  * ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale`` are replicated; a rank takes its channels or heads of
    each through ``tp.local``, whose ``copy`` sums their gradients.  The
    SSD runs on the rank's [B, L, H/m, p].
  * the gated RMSNorm normalises over the whole d_inner: the sum of squares
    of the rank's channels goes through ``tp.sum`` ([B, L, 1], its gradient
    summed too, since each rank uses it on its own channels);
    ``out_proj`` is row-parallel: its rows are the rank's channels, one
    ``reduce``.
  * the shared block attends with the rank's heads and runs its MLP
    columns (``layers.attention`` / ``mlp`` under ``tp``: K6 and K6b on
    the rank's heads); the vocab-split tied table feeds ``layers.embed`` and
    the vocab-parallel cross entropy.

Where the SSM heads do not divide the axis every rank runs every head on
whole leaves.  Where the sequence length (a prefix joined on) divides the
axis, the stream's sequence is split over it between blocks
(``TensorParallel.over``): each block's norm and residual add act on a
rank's rows (``ln`` through ``copy``), ``mamba_mix`` gathers the whole
sequence at its entry (the causal conv and the SSD run on it, so their
states are the whole sequence's) and reduce-scatters its output; the gated
RMSNorm's sum stays a sum over channels for each token.  The decode state holds the rank's part: ``ssm`` [L, B,
H/m, p, s], ``conv`` [L, B, K-1, di/m] (its heads' channels, the block
``cache_specs``' last-dim split gives), and the shared block's KV heads
(``transformer.init_kv_cache``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import shard_slices, shard_tree
from repro_torch.mapreduce.executor import _device

from .layers import (
    apply_norm,
    attention,
    attention_decode,
    chunked_cross_entropy,
    embed,
    head_split,
    init_norm,
    mlp,
    remat as remat_block,
)
from .tensor_parallel import parts
from .transformer import (
    _readout,
    attn_config,
    init_attention,
    logits_table,
    norm,
    split_table,
    stream_in,
    stream_out,
)

_CONV_K = 4


# ---------------------------------------------------------------------- init
def init_params(
    cfg: ArchConfig, seed: int, device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32, tp=None,
) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    from the distributions of ``repro.models.mamba2``: dense weights
    N(0, 1/fan_in), ``conv_w`` N(0, 0.25), the embedding N(0, 0.02^2),
    ``A_log`` 0 (A = -1), ``D`` 1, ``dt_bias`` -1, biases 0, norm scales 1.
    Each tensor is drawn in fp32 and cast to ``dtype`` at once.  (``jax.random``
    draws other numbers: tests carry JAX weights across with
    ``convert.params_from_jax``.)  Under ``tp`` every rank draws every whole
    leaf in the same order, a block at a time, and keeps its block of each:
    the one-rank model's parameters, sliced."""
    dev = _device(device)

    def keep(tree, spec):
        return tree if tp is None else shard_tree(tree, spec, tp.mesh)

    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f32 = torch.float32

    def normal(shape, scale: float) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=dev, dtype=f32)
        return (w * scale).to(dtype)

    def dense(d_in: int, d_out: int) -> torch.Tensor:
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    d, di, st, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    blocks = []
    for i in range(cfg.n_layers):
        blocks.append(keep({
            "ln": init_norm(cfg.norm, d, dev, dtype),
            "in_proj": dense(d, 2 * di + 2 * st + h),
            "conv_w": normal((_CONV_K, di), 0.5),
            "conv_b": torch.zeros(di, dtype=dtype, device=dev),
            "A_log": torch.zeros(h, dtype=f32, device=dev),
            "D": torch.ones(h, dtype=f32, device=dev),
            "dt_bias": torch.full((h,), -1.0, dtype=f32, device=dev),
            "norm_scale": torch.ones(di, dtype=dtype, device=dev),
            "out_proj": dense(di, d),
        }, tp and tp.specs["blocks"][i]))
    table = torch.randn((cfg.vocab, d), generator=gen, device=dev, dtype=f32)
    if tp is not None:  # the slice before the scale: one whole fp32 table at a time
        table = table[shard_slices(table.shape, tp.specs["embed"]["table"], tp.mesh)]
    params = {
        "embed": {"table": (table * 0.02).to(dtype)},
        "blocks": blocks,
        "final_norm": init_norm(cfg.norm, d, dev, dtype),
    }
    if cfg.hybrid_period:
        params["shared_attn"] = keep({
            "ln1": init_norm(cfg.norm, d, dev, dtype),
            "attn": init_attention(cfg, dense, dev, dtype),
            "ln2": init_norm(cfg.norm, d, dev, dtype),
            "mlp": {"w_up": dense(d, cfg.d_ff), "w_down": dense(cfg.d_ff, d)},
        }, tp and tp.specs["shared_attn"])
    if not cfg.tie_embeddings:
        params["lm_head"] = keep({"w": dense(d, cfg.vocab)}, tp and tp.specs["lm_head"])
    return params


# ----------------------------------------------------------------- the mixer
def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time. x [B, L, di]; w [K, di].  ``state``
    carries the last K-1 inputs for decode.  Returns (y, new_state), the
    taps summed in the JAX package's order."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xx = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xx[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k)) + b.to(x.dtype)
    return y, xx[:, -(k - 1):, :]


def ssd(
    xh: torch.Tensor,  # [B, L, H, p] f32
    dt: torch.Tensor,  # [B, L, H] f32
    log_decay: torch.Tensor,  # [B, L, H] f32, dt * A <= 0
    bmat: torch.Tensor,  # [B, L, s] f32
    cmat: torch.Tensor,  # [B, L, s] f32
    s0: torch.Tensor,  # [B, H, p, s] f32
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence ``S_t = exp(log_decay_t) S_{t-1} + (dt_t x_t) ⊗ B_t``,
    ``y_t = S_t C_t``; returns (y [B, L, H, p], the state after token L).

    L = 1 is the direct update.  Otherwise, in chunks of ``chunk`` tokens
    (an L the chunk does not divide is padded with dt 0 and decay 1, as the
    JAX package pads it): with Λ the cumulative log decay inside a chunk,
    the chunk's own tokens give ``((C Bᵀ) ∘ exp(Λ_t - Λ_r)[r <= t]) (dt x)``
    and the state it starts from ``exp(Λ_t) C S_0ᵀ``; its end state is
    ``exp(Λ_Q) S_0 + Σ_r exp(Λ_Q - Λ_r) (dt_r x_r) ⊗ B_r``, carried across
    the chunks by a loop.  Every exponent is a sum of log decays (<= 0), so
    no exp exceeds 1."""
    b, l, h, p = xh.shape
    u = dt[..., None] * xh  # dt_t x_t
    if l == 1:
        s = torch.exp(log_decay[:, 0, :, None, None]) * s0 \
            + u[:, 0, :, :, None] * bmat[:, 0, None, None, :]
        return torch.einsum("bhps,bs->bhp", s, cmat[:, 0])[:, None], s
    q = min(chunk, l)
    n = math.ceil(l / q)
    pad = n * q - l
    if pad:  # dt 0 (so u 0) and decay 1 past L: the state passes through
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s_dim = bmat.shape[-1]
    uc = u.reshape(b, n, q, h, p).permute(0, 1, 3, 2, 4)  # [B, n, H, Q, p]
    cum = log_decay.reshape(b, n, q, h).permute(0, 1, 3, 2).cumsum(-1)  # Λ [B, n, H, Q]
    bc = bmat.reshape(b, n, 1, q, s_dim)
    cc = cmat.reshape(b, n, 1, q, s_dim)
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, float("-inf"))
    scores = (cc @ bc.transpose(-1, -2)) * torch.exp(seg)  # [B, n, H, Q, Q]
    y = scores @ uc  # the chunk's own tokens
    tail = torch.exp(cum[..., -1:] - cum)  # exp(Λ_Q - Λ_r)
    local = (uc * tail[..., None]).transpose(-1, -2) @ bc  # [B, n, H, p, s]
    keep = torch.exp(cum[..., -1])[..., None, None]  # exp(Λ_Q) [B, n, H, 1, 1]
    starts = []
    s = s0
    for c in range(n):
        starts.append(s)
        s = keep[:, c] * s + local[:, c]
    start = torch.stack(starts, dim=1)  # [B, n, H, p, s]
    y = y + torch.exp(cum)[..., None] * (cc @ start.transpose(-1, -2))
    y = y.permute(0, 1, 3, 2, 4).reshape(b, n * q, h, p)
    return y[:, :l], s


def mamba_mix(p: dict, x: torch.Tensor, cfg: ArchConfig, ssm_state=None, conv_state=None,
              chunk: int = 64, tp=None):
    """One Mamba2 mixer on x [B, L, d]: returns (output [B, L, d], SSM state
    [B, H, p, s] f32, conv state [B, K-1, di]).  Under ``tp``: this rank's
    heads (states [B, H/m, p, s] and [B, K-1, di/m]), the output summed
    over the group (``x`` and the output this rank's rows where ``tp.seq``,
    the states the whole sequence's)."""
    di, st, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    heads = tp.block(h) if tp is not None else None
    if tp is not None:
        x = tp.enter(x, heads is not None)
    b, l, _ = x.shape
    hd = di // h
    h0, h1 = heads or (0, h)
    c0, c1 = h0 * hd, h1 * hd
    part = parts(p, "", tp, heads is not None)
    w_in = part("in_proj", 1, 0, 2 * di + 2 * st + h, x.dtype)
    if heads is not None:  # the whole leaf through ``copy``; its columns of z, x, B, C, dt
        full = w_in
        w_in = torch.cat([full[:, c0:c1], full[:, di + c0:di + c1], full[:, 2 * di:2 * di + 2 * st],
                          full[:, 2 * di + 2 * st + h0:2 * di + 2 * st + h1]], dim=1)
    n, dn = h1 - h0, c1 - c0
    proj = x @ w_in
    z, xin, bmat, cmat, dtr = torch.split(proj, [dn, dn, st, st, n], dim=-1)
    xin, conv_state = _causal_conv(xin, part("conv_w", 1, c0, c1), part("conv_b", 0, c0, c1),
                                   conv_state)
    xin = F.silu(xin)
    dt = F.softplus(dtr.float() + part("dt_bias", 0, h0, h1).float())  # [B, L, H]
    log_decay = dt * -torch.exp(part("A_log", 0, h0, h1).float())
    xh = xin.reshape(b, l, n, hd)
    if ssm_state is None:
        ssm_state = torch.zeros((b, n, hd, st), dtype=torch.float32, device=x.device)
    y, s = ssd(xh.float(), dt, log_decay, bmat.float(), cmat.float(), ssm_state, chunk)
    y = y + part("D", 0, h0, h1).float()[None, None, :, None] * xh.float()
    y = y.reshape(b, l, dn).to(x.dtype)
    yf = (y * F.silu(z)).float()  # the gated RMSNorm over the whole d_inner
    ss = (yf * yf).sum(-1, keepdim=True)
    if heads is not None:  # every rank's channels
        ss = tp.sum(ss)
    y = (yf * torch.rsqrt(ss / di + 1e-6)).to(x.dtype) * part("norm_scale", 0, c0, c1).to(x.dtype)
    out = y @ part("out_proj", 0, c0, c1, x.dtype)
    return (out if tp is None else tp.leave(out, heads is not None)), s, conv_state


# ------------------------------------------------------------------- forward
def _groups(cfg: ArchConfig) -> tuple[int, int]:
    period = cfg.hybrid_period or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError("hybrid_period must divide n_layers")
    return cfg.n_layers // period, period


def _mamba_body(cfg: ArchConfig, blk: dict, x: torch.Tensor, chunk: int, tp=None) -> torch.Tensor:
    y, _, _ = mamba_mix(blk, norm(cfg, blk["ln"], x, tp), cfg, chunk=chunk, tp=tp)
    return x + y


def _shared_apply(cfg: ArchConfig, shared: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    h = norm(cfg, shared["ln1"], x, tp)
    x = x + attention(shared["attn"], attn_config(cfg), h, tp=tp)
    h = norm(cfg, shared["ln2"], x, tp)
    return x + mlp(shared["mlp"], h, cfg.act, tp)


def forward_hidden(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    prefix_embeds: torch.Tensor | None = None,  # [B, P, d]
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    chunk: int = 64,
    tp=None,
) -> torch.Tensor:
    """Token (+ prefix) embeddings -> final-norm hidden states [B, L*, d],
    whole on every rank.  ``remat``: recompute each Mamba block and each
    invocation of the shared block in the backward.  Under ``tp`` the
    sequence is split between blocks where its length divides the model
    axis (``transformer.stream_in``)."""
    x, tp = stream_in(params, tokens, prefix_embeds, dtype, tp)
    n_groups, period = _groups(cfg)
    run = remat_block if remat else (lambda fn, *args: fn(*args))
    for g in range(n_groups):
        for blk in params["blocks"][g * period:(g + 1) * period]:
            x = run(_mamba_body, cfg, blk, x, chunk, tp)
        if cfg.hybrid_period:
            x = run(_shared_apply, cfg, params["shared_attn"], x, tp)
    return stream_out(cfg, params, x, tp)


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
    tp=None,
) -> torch.Tensor:
    """Next-token cross entropy through the tied embedding (or the head);
    differentiable.  Under ``tp`` the readout on this rank's vocab block."""
    tokens = batch["tokens"]
    h = forward_hidden(cfg, params, tokens, dtype=dtype, remat=remat, tp=tp)
    if tp is None:
        return chunked_cross_entropy(h[:, :-1, :], logits_table(cfg, params), tokens[:, 1:],
                                     chunk=loss_chunk)
    table, split = split_table(cfg, params, h.dtype, tp)
    return chunked_cross_entropy(h[:, :-1, :], table, tokens[:, 1:], chunk=loss_chunk,
                                 tp=tp if split else None)


# ------------------------------------------------------------------ serving
def init_state(
    cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda", tp=None,
) -> dict:
    """Zeroed decode state in the JAX package's layout: ``ssm`` [n_layers, B,
    H, p, s] float32, ``conv`` [n_layers, B, K-1, di] and one KV cache for
    each invocation of the shared block, ``k`` and ``v`` [n_groups, B, n_kv,
    max_seq, hd], in ``dtype``.  ``decode_step`` updates it in place.  Under
    ``tp`` this rank's SSM heads and their channels, and the KV heads of its
    attention heads."""
    dev = _device(device)
    l, h, st, di = cfg.n_layers, cfg.ssm_heads, cfg.ssm_state, cfg.d_inner
    heads = tp.block(h) if tp is not None else None
    n = h if heads is None else heads[1] - heads[0]
    n_groups, _ = _groups(cfg)
    state = {
        "ssm": torch.zeros((l, batch, n, di // h, st), dtype=torch.float32, device=dev),
        "conv": torch.zeros((l, batch, _CONV_K - 1, n * (di // h)), dtype=dtype, device=dev),
    }
    if cfg.hybrid_period:
        split = head_split(attn_config(cfg), tp)
        n_kv = cfg.n_kv if split is None else split[1][1] - split[1][0]
        shape = (n_groups, batch, n_kv, max_seq, cfg.hd)
        state["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return state


def decode_step(
    cfg: ArchConfig,
    params: dict,
    state: dict,
    tokens: torch.Tensor,  # [B, 1]
    pos: int,  # tokens already in the KV caches
    dtype: torch.dtype = torch.bfloat16,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One token step; returns (logits [B, V] float32, state), the state
    updated in place.  Under ``tp`` the logits are put together over the
    vocab, the same on every rank."""
    x = embed(params["embed"], tokens, dtype, tp)
    n_groups, period = _groups(cfg)
    acfg = attn_config(cfg)
    for g in range(n_groups):
        for li in range(g * period, (g + 1) * period):
            blk = params["blocks"][li]
            y, s, cs = mamba_mix(blk, apply_norm(cfg.norm, blk["ln"], x), cfg,
                                 ssm_state=state["ssm"][li], conv_state=state["conv"][li],
                                 chunk=1, tp=tp)
            x = x + y
            state["ssm"][li] = s
            state["conv"][li] = cs
        if cfg.hybrid_period:
            shared = params["shared_attn"]
            h = apply_norm(cfg.norm, shared["ln1"], x)
            x = x + attention_decode(shared["attn"], acfg, h, state["k"][g], state["v"][g],
                                     int(pos), tp=tp)
            h = apply_norm(cfg.norm, shared["ln2"], x)
            x = x + mlp(shared["mlp"], h, cfg.act, tp)
    return _readout(cfg, params, x, tp), state
