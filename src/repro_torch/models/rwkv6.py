"""RWKV-6 "Finch" (attention-free, data-dependent decay), rwkv6-3b: the
counterpart of ``repro.models.rwkv6``, forward and serving.

Core recurrence per head (k-dim i, v-dim j)::

    y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
    S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]

with the data-dependent decay ``w_t = exp(-exp(w0 + tanh(x W_A) W_B))``
(arXiv:2404.05892).  The recurrence is ``kernels.wkv6.wkv6``: the
hand-written kernel (K7) for CUDA tensors, its plain version on the CPU.  It
takes the whole sequence in one launch, so the JAX package's chunked,
token-blocked scan (a device of XLA's) has no counterpart here; under a
gradient its backward is K7b, which recomputes the states it needs from
one saved every 8 tokens of its own, as the JAX package's checkpointed
outer scan recomputes its chunks.

Parameters are a dict as in ``models.transformer``: ``blocks`` is a list of
per-layer dicts (``ln1``, ``tm``, ``ln2``, ``cm``).  The projection
matrices, the embedding, the head and the ``mu_*`` mixing weights are kept in
the compute dtype, as the JAX package casts them at use; the decay
parameters ``w0``, ``wA``, ``wB``, the bonus ``u``, the group norm ``ln_x``
and the layer norms stay float32 in every dtype, as the JAX package computes
with them in float32.  The JAX package's activation-sharding hook and its
performance knobs (``REPRO_WKV_UNROLL``, ``REPRO_WKV_IO_DTYPE``) are not
carried over: the recurrence's inputs are float32 here.

Training: ``loss_fn`` differentiates on either device (``wkv6``'s
``Wkv6Fn``: K7 and K7b on the card, the plain recurrence and its explicit
reverse on the CPU), and ``forward_hidden(remat=True)`` recomputes each
block's activations in the backward (``layers.remat``, the JAX package's
``jax.checkpoint`` of a block).

Every function takes ``tp`` (``tensor_parallel.TensorParallel``; None: the
whole model on this rank), the counterpart of the JAX package's
``constrain_activations`` under ``--mesh prod``: a rank runs heads [h0, h1)
of the time mix (``tp.block(n_heads)``) and its block of the channel mix's
d_ff, as ``launch.sharding.param_specs`` places each leaf:

  * time mix: ``Wr``, ``Wk``, ``Wg`` are column-parallel, so a rank's
    column block gives r, k and g for its heads.  ``Wv`` is row-parallel
    (the rules split its input dim), so a rank's block would give a partial
    v over every head; the rank instead gathers ``Wv`` whole in the compute
    dtype and takes its heads' columns (``tp.local``): d² a layer (13 MB in
    bf16 at rwkv6-3b's d = 2560, whatever the batch), where a ``reduce`` of
    the partial v would move [B, L, d] (42 MB at [4, 2048]) and need its
    gradient summed too.  The decay LoRA's ``wA`` (split on d by the generic
    rule at full size) is gathered whole in fp32 (655 KB): ``tanh`` needs
    the whole [B, L, 64] product; ``wB``'s column block is the rank's
    channels.  ``mu_*``, ``w0``, ``u`` and ``ln_x`` are replicated and a
    rank takes its part of each through ``tp.local``, whose ``copy`` sums
    their gradients over the group.  The input x goes through ``copy`` once:
    every lerp ``x + (shift(x) - x) mu`` is linear in x and in mu, so with
    each mu through ``copy`` too, one [B, L, d] ``all_reduce`` of x's
    gradient sums all five lerp outputs' gradients.  K7 (K7b under a
    gradient) runs on the rank's [B, L, H/m, hd], the per-head group norm
    is local, and ``Wo`` is row-parallel: one ``reduce``.
  * channel mix: ``Wk`` (column-parallel) and ``Wv`` (row-parallel) pair
    up Megatron's way, the ``mu_k`` lerp's output through ``copy`` and the
    partial v through one ``reduce``.  ``Wr`` is column-parallel, but
    ``sigmoid(r)`` multiplies the whole v: every rank takes ``Wr`` whole
    (gathered in the compute dtype, d² a layer) and computes the whole r
    alike, where multiplying its r columns by v's and gathering the product
    would move [B, L, d] and need v's gradient summed.  Where the sequence
    is split (below), r is computed on the rank's own rows only, against
    the whole ``Wr`` through ``copy``.
  * the vocab-split table goes through ``layers.embed(tp=)``, the untied
    head's vocab block feeds the vocab-parallel cross entropy, and decode
    logits are put together over the vocab.

Where the heads do not divide the axis (rwkv6-3b's 40 at model 16), every
rank runs every head of the time mix on whole leaves (gathered where the
rules split them).

Where the sequence length divides the model axis, the stream's sequence is
split over it between blocks (``TensorParallel.over``, the JAX package's
``P(dp, "model", None)``): ``ln0``, ``ln1``, ``ln2``, the final norm and
the residual adds act on a rank's rows (their leaves through ``copy``,
``row_leaves``); each mix gathers the whole sequence at its
entry (``TensorParallel.enter``: the token shift, the lerps and the decay
run on it, as one gather serves the five lerps) and reduce-scatters its
output (``leave``).  The decode state's ``wkv`` holds the rank's heads
[L, B, H/m, hd, hd], as ``cache_specs`` splits it; ``x_tm`` and ``x_cm``
stay whole [L, B, d] on every rank, where ``cache_specs`` splits their d:
a rank's lerps read the whole previous token, since the stream is whole.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.launch.sharding import shard_tree
from repro_torch.mapreduce.executor import _device

from .layers import chunked_cross_entropy, embed, init_norm, layer_norm
from .layers import remat as remat_block
from .tensor_parallel import parts, row_leaves
from .transformer import _readout, split_table, stream_in

_LORA = 64
_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")


# ---------------------------------------------------------------------- init
def init_params(
    cfg: ArchConfig, seed: int, device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32, tp=None,
) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    from the distributions of ``repro.models.rwkv6``: dense weights
    N(0, 1/fan_in), ``wB`` N(0, 0.01^2), the embedding N(0, 0.02^2),
    ``mu_*`` = 0.5, ``w0`` = -2, ``u`` = 0, norm scales 1 and biases 0, an
    untied ``lm_head``.  (``jax.random`` draws other numbers: tests carry JAX
    weights across with ``convert.params_from_jax``.)  Under ``tp`` every
    rank draws every whole leaf in the same order, a block at a time, and
    keeps its block of each: the one-rank model's parameters, sliced."""
    dev = _device(device)

    def keep(tree, spec):
        return tree if tp is None else shard_tree(tree, spec, tp.mesh)

    gen = torch.Generator(device=dev).manual_seed(int(seed))
    f32 = torch.float32

    def normal(shape, scale: float, keep: torch.dtype = dtype) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=dev, dtype=f32)
        return (w * scale).to(keep)

    def dense(d_in: int, d_out: int) -> torch.Tensor:
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def full(shape, value: float, keep: torch.dtype = f32) -> torch.Tensor:
        return torch.full(shape, value, dtype=keep, device=dev)

    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff
    blocks = []
    for i in range(cfg.n_layers):
        tm = {mu: full((d,), 0.5, dtype) for mu in _MU}
        tm.update(
            w0=full((d,), -2.0),
            wA=normal((d, _LORA), 1.0 / math.sqrt(d), f32),
            wB=normal((_LORA, d), 0.01, f32),
            Wr=dense(d, d), Wk=dense(d, d), Wv=dense(d, d), Wg=dense(d, d), Wo=dense(d, d),
            u=full((h, hd), 0.0),
            ln_x=init_norm("layer", d, dev),
        )
        cm = {"mu_k": full((d,), 0.5, dtype), "mu_r": full((d,), 0.5, dtype),
              "Wk": dense(d, f), "Wv": dense(f, d), "Wr": dense(d, d)}
        blocks.append(keep({"ln1": init_norm("layer", d, dev), "tm": tm,
                            "ln2": init_norm("layer", d, dev), "cm": cm},
                           tp and tp.specs["blocks"][i]))
    return {
        "embed": keep({"table": normal((cfg.vocab, d), 0.02)}, tp and tp.specs["embed"]),
        "ln0": init_norm("layer", d, dev),
        "blocks": blocks,
        "final_norm": init_norm("layer", d, dev),
        "lm_head": keep({"w": dense(d, cfg.vocab)}, tp and tp.specs["lm_head"]),
    }


# ------------------------------------------------------------------- forward
def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Previous-token version of x; ``prev`` is the carried last token
    (taken in x's dtype)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(
    tm: dict, x: torch.Tensor, cfg: ArchConfig, s0: torch.Tensor | None = None,
    x_prev: torch.Tensor | None = None, state_out: torch.Tensor | None = None, tp=None,
):
    """Returns (output [B, L, d], final wkv state [B, H, hd, hd] f32, last
    token of x); the state is written into ``state_out`` when given (which
    may be ``s0``).  Under ``tp``: this rank's heads (the state [B, H/m, hd,
    hd]), the output summed over the group (``x`` and the output this rank's
    rows where ``tp.seq``; the last token that of the whole sequence)."""
    heads = tp.block(cfg.n_heads) if tp is not None else None
    if tp is not None:  # every lerp's gradient summed, with each mu's (``part``)
        x = tp.enter(x, heads is not None)
    b, l, d = x.shape
    hd = cfg.hd
    h0, h1 = heads or (0, cfg.n_heads)
    c0, c1 = h0 * hd, h1 * hd
    part = parts(tm, "tm/", tp, heads is not None)
    dt = x.dtype
    dx = _shift(x, x_prev) - x  # once for the five interpolations

    def lerp(mu):
        return x + dx * part(mu, 0, 0, d).to(dt)

    r = (lerp("mu_r") @ part("Wr", 1, c0, c1, dt)).reshape(b, l, h1 - h0, hd)
    k = (lerp("mu_k") @ part("Wk", 1, c0, c1, dt)).reshape(b, l, h1 - h0, hd)
    v = (lerp("mu_v") @ part("Wv", 1, c0, c1, dt)).reshape(b, l, h1 - h0, hd)
    g = F.silu(lerp("mu_g") @ part("Wg", 1, c0, c1, dt))
    lw = lerp("mu_w").float()
    f32 = torch.float32
    w = torch.exp(
        -torch.exp(part("w0", 0, c0, c1, f32)
                   + torch.tanh(lw @ part("wA", 1, 0, _LORA, f32)) @ part("wB", 1, c0, c1, f32))
    ).reshape(b, l, h1 - h0, hd)
    y, s = wkv6(r.float(), k.float(), v.float(), w, part("u", 0, h0, h1, f32), s0, state_out)
    # per-head group norm: normalize within each head, scale per channel
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    y = (yn.reshape(b, l, c1 - c0) * part("ln_x/scale", 0, c0, c1, f32)
         + part("ln_x/bias", 0, c0, c1, f32))
    out = (y.to(dt) * g) @ part("Wo", 0, c0, c1, dt)
    return (out if tp is None else tp.leave(out, heads is not None)), s, x[:, -1]


def channel_mix(cm: dict, x: torch.Tensor, x_prev: torch.Tensor | None = None, tp=None):
    """Returns (output [B, L, d], last token of x).  Under ``tp``: this
    rank's block of d_ff (where it divides the axis), v summed over the
    group, r whole on every rank; where ``tp.seq``, ``x`` and the output are
    this rank's rows, v is reduce-scattered to them and r computed on them
    alone."""
    d = x.shape[-1]
    f = cm["Wk"].shape[-1] if tp is None else tp.leaf_split["cm/Wk"][0][1]
    cols = tp.block(f) if tp is not None else None
    rows = cols is not None and tp.seq  # r on this rank's rows
    if tp is not None and tp.seq:
        x = tp.enter(x, cols is not None)
    dx = _shift(x, x_prev) - x
    dt = x.dtype
    lo, hi = cols or (0, f)
    split = parts(cm, "cm/", tp, cols is not None)
    whole = parts(cm, "cm/", tp, False)
    # a mu used on this rank's part has its gradient summed over the group
    mu = split if rows else whole

    def lerp(name, xs=x, dxs=dx):
        return xs + dxs * mu(name, 0, 0, d).to(dt)

    xk = tp.copy(lerp("mu_k")) if cols is not None and not rows else lerp("mu_k")
    k = torch.square(F.relu(xk @ split("Wk", 1, lo, hi, dt)))
    v = k @ split("Wv", 0, lo, hi, dt)
    if rows:
        r0, r1 = tp.block(x.shape[1])
        r = torch.sigmoid(lerp("mu_r", x[:, r0:r1], dx[:, r0:r1]) @ split("Wr", 1, 0, d, dt))
        return r * tp.leave(v, True), x[:, -1]
    if cols is not None:
        v = tp.reduce(v)
    r = torch.sigmoid(lerp("mu_r") @ whole("Wr", 1, 0, d, dt))
    return (r * v if tp is None else tp.leave(r * v, False)), x[:, -1]


def _block_apply(cfg: ArchConfig, blk: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    y, _, _ = time_mix(blk["tm"], layer_norm(row_leaves(tp, blk["ln1"]), x), cfg, tp=tp)
    x = x + y
    y, _ = channel_mix(blk["cm"], layer_norm(row_leaves(tp, blk["ln2"]), x), tp=tp)
    return x + y


def forward_hidden(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    tp=None,
) -> torch.Tensor:
    """Token embeddings -> final-norm hidden states [B, L, d], whole on
    every rank; every layer's recurrence starts from a zero state.
    ``remat``: each block's activations are recomputed in the backward
    (only where one will run).  Under ``tp`` the sequence is split between
    blocks where its length divides the model axis."""
    x, tp = stream_in(params, tokens, None, dtype, tp)
    x = layer_norm(row_leaves(tp, params["ln0"]), x)
    run = remat_block if remat else (lambda fn, *args: fn(*args))
    for blk in params["blocks"]:
        x = run(partial(_block_apply, cfg, tp=tp), blk, x)
    x = layer_norm(row_leaves(tp, params["final_norm"]), x)
    return x if tp is None else tp.enter(x, False)


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
    tp=None,
) -> torch.Tensor:
    """Next-token cross entropy through the untied head; differentiable,
    each block rematerialised in the backward under ``remat``."""
    tokens = batch["tokens"]
    h = forward_hidden(cfg, params, tokens, dtype=dtype, remat=remat, tp=tp)
    if tp is None:
        return chunked_cross_entropy(h[:, :-1, :], params["lm_head"]["w"].T, tokens[:, 1:],
                                     chunk=loss_chunk)
    table, split = split_table(cfg, params, h.dtype, tp)
    return chunked_cross_entropy(h[:, :-1, :], table, tokens[:, 1:], chunk=loss_chunk,
                                 tp=tp if split else None)


# ------------------------------------------------------------------ serving
def init_state(
    cfg: ArchConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda", tp=None,
) -> dict:
    """Zeroed recurrent state in the JAX package's layout: ``wkv``
    ``[n_layers, B, H, hd, hd]`` float32, ``x_tm`` and ``x_cm``
    ``[n_layers, B, d]`` in ``dtype`` (the compute dtype).  Its size does not
    grow with the context.  ``decode_step`` updates it in place (the JAX
    package returns a new state).  Under ``tp`` ``wkv`` holds this rank's
    heads (all of them where they do not split)."""
    l, hd, d = cfg.n_layers, cfg.hd, cfg.d_model
    heads = tp.block(cfg.n_heads) if tp is not None else None
    h = cfg.n_heads if heads is None else heads[1] - heads[0]
    dev = _device(device)
    return {
        "wkv": torch.zeros((l, batch, h, hd, hd), dtype=torch.float32, device=dev),
        "x_tm": torch.zeros((l, batch, d), dtype=dtype, device=dev),
        "x_cm": torch.zeros((l, batch, d), dtype=dtype, device=dev),
    }


def _block_step(cfg: ArchConfig, blk: dict, x: torch.Tensor, state: dict, i: int, tp=None):
    """Layer i of ``decode_step`` on x [B, 1, d]; the layer's state is
    updated in place."""
    wkv = state["wkv"][i]
    y, _, last = time_mix(blk["tm"], layer_norm(blk["ln1"], x), cfg, s0=wkv,
                          x_prev=state["x_tm"][i], state_out=wkv, tp=tp)
    state["x_tm"][i] = last
    x = x + y
    y, last = channel_mix(blk["cm"], layer_norm(blk["ln2"], x), x_prev=state["x_cm"][i], tp=tp)
    state["x_cm"][i] = last
    return x + y


def decode_step(
    cfg: ArchConfig,
    params: dict,
    state: dict,
    tokens: torch.Tensor,  # [B, 1]
    pos=None,  # unused: the state is position-free
    dtype: torch.dtype = torch.bfloat16,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One token step; returns (logits [B, V] float32, state), the state
    updated in place (each layer's wkv state by the recurrence itself).
    Under ``tp`` the logits are put together over the vocab, the same on
    every rank."""
    x = layer_norm(params["ln0"], embed(params["embed"], tokens, dtype, tp))
    for i, blk in enumerate(params["blocks"]):
        x = _block_step(cfg, blk, x, state, i, tp)
    return _readout(cfg, params, x, tp), state
