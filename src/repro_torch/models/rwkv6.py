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
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.mapreduce.executor import _device

from .layers import chunked_cross_entropy, embed, init_norm, layer_norm
from .layers import remat as remat_block

_LORA = 64
_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")


# ---------------------------------------------------------------------- init
def init_params(
    cfg: ArchConfig, seed: int, device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    from the distributions of ``repro.models.rwkv6``: dense weights
    N(0, 1/fan_in), ``wB`` N(0, 0.01^2), the embedding N(0, 0.02^2),
    ``mu_*`` = 0.5, ``w0`` = -2, ``u`` = 0, norm scales 1 and biases 0, an
    untied ``lm_head``.  (``jax.random`` draws other numbers: tests carry JAX
    weights across with ``convert.params_from_jax``.)"""
    dev = _device(device)
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
    for _ in range(cfg.n_layers):
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
        blocks.append({"ln1": init_norm("layer", d, dev), "tm": tm,
                       "ln2": init_norm("layer", d, dev), "cm": cm})
    return {
        "embed": {"table": normal((cfg.vocab, d), 0.02)},
        "ln0": init_norm("layer", d, dev),
        "blocks": blocks,
        "final_norm": init_norm("layer", d, dev),
        "lm_head": {"w": dense(d, cfg.vocab)},
    }


# ------------------------------------------------------------------- forward
def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Previous-token version of x; ``prev`` is the carried last token
    (taken in x's dtype)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(
    tm: dict, x: torch.Tensor, cfg: ArchConfig, s0: torch.Tensor | None = None,
    x_prev: torch.Tensor | None = None, state_out: torch.Tensor | None = None,
):
    """Returns (output [B, L, d], final wkv state [B, H, hd, hd] f32, last
    token of x); the state is written into ``state_out`` when given (which
    may be ``s0``)."""
    b, l, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    dx = _shift(x, x_prev) - x  # once for the five interpolations

    def lerp(mu):
        return x + dx * mu.to(x.dtype)

    r = (lerp(tm["mu_r"]) @ tm["Wr"].to(x.dtype)).reshape(b, l, h, hd)
    k = (lerp(tm["mu_k"]) @ tm["Wk"].to(x.dtype)).reshape(b, l, h, hd)
    v = (lerp(tm["mu_v"]) @ tm["Wv"].to(x.dtype)).reshape(b, l, h, hd)
    g = F.silu(lerp(tm["mu_g"]) @ tm["Wg"].to(x.dtype))
    lw = lerp(tm["mu_w"]).float()
    w = torch.exp(
        -torch.exp(tm["w0"].float() + torch.tanh(lw @ tm["wA"].float()) @ tm["wB"].float())
    ).reshape(b, l, h, hd)
    y, s = wkv6(r.float(), k.float(), v.float(), w, tm["u"].float(), s0, state_out)
    # per-head group norm: normalize within each head, scale per channel
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    y = (yn.reshape(b, l, d) * tm["ln_x"]["scale"].float() + tm["ln_x"]["bias"].float())
    out = (y.to(x.dtype) * g) @ tm["Wo"].to(x.dtype)
    return out, s, x[:, -1]


def channel_mix(cm: dict, x: torch.Tensor, x_prev: torch.Tensor | None = None):
    """Returns (output [B, L, d], last token of x)."""
    dx = _shift(x, x_prev) - x

    def lerp(mu):
        return x + dx * mu.to(x.dtype)

    k = torch.square(F.relu(lerp(cm["mu_k"]) @ cm["Wk"].to(x.dtype)))
    v = k @ cm["Wv"].to(x.dtype)
    r = torch.sigmoid(lerp(cm["mu_r"]) @ cm["Wr"].to(x.dtype))
    return r * v, x[:, -1]


def _block_apply(cfg: ArchConfig, blk: dict, x: torch.Tensor) -> torch.Tensor:
    y, _, _ = time_mix(blk["tm"], layer_norm(blk["ln1"], x), cfg)
    x = x + y
    y, _ = channel_mix(blk["cm"], layer_norm(blk["ln2"], x))
    return x + y


def forward_hidden(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
) -> torch.Tensor:
    """Token embeddings -> final-norm hidden states [B, L, d]; every layer's
    recurrence starts from a zero state.  ``remat``: each block's
    activations are recomputed in the backward (only where one will run)."""
    x = layer_norm(params["ln0"], embed(params["embed"], tokens, dtype))
    run = remat_block if remat else (lambda fn, *args: fn(*args))
    for blk in params["blocks"]:
        x = run(partial(_block_apply, cfg), blk, x)
    return layer_norm(params["final_norm"], x)


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
) -> torch.Tensor:
    """Next-token cross entropy through the untied head; differentiable,
    each block rematerialised in the backward under ``remat``."""
    tokens = batch["tokens"]
    h = forward_hidden(cfg, params, tokens, dtype=dtype, remat=remat)
    return chunked_cross_entropy(h[:, :-1, :], params["lm_head"]["w"].T, tokens[:, 1:],
                                 chunk=loss_chunk)


# ------------------------------------------------------------------ serving
def init_state(
    cfg: ArchConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> dict:
    """Zeroed recurrent state in the JAX package's layout: ``wkv``
    ``[n_layers, B, H, hd, hd]`` float32, ``x_tm`` and ``x_cm``
    ``[n_layers, B, d]`` in ``dtype`` (the compute dtype).  Its size does not
    grow with the context.  ``decode_step`` updates it in place (the JAX
    package returns a new state)."""
    l, h, hd, d = cfg.n_layers, cfg.n_heads, cfg.hd, cfg.d_model
    dev = _device(device)
    return {
        "wkv": torch.zeros((l, batch, h, hd, hd), dtype=torch.float32, device=dev),
        "x_tm": torch.zeros((l, batch, d), dtype=dtype, device=dev),
        "x_cm": torch.zeros((l, batch, d), dtype=dtype, device=dev),
    }


def _block_step(cfg: ArchConfig, blk: dict, x: torch.Tensor, state: dict, i: int):
    """Layer i of ``decode_step`` on x [B, 1, d]; the layer's state is
    updated in place."""
    wkv = state["wkv"][i]
    y, _, last = time_mix(blk["tm"], layer_norm(blk["ln1"], x), cfg, s0=wkv,
                          x_prev=state["x_tm"][i], state_out=wkv)
    state["x_tm"][i] = last
    x = x + y
    y, last = channel_mix(blk["cm"], layer_norm(blk["ln2"], x), x_prev=state["x_cm"][i])
    state["x_cm"][i] = last
    return x + y


def decode_step(
    cfg: ArchConfig,
    params: dict,
    state: dict,
    tokens: torch.Tensor,  # [B, 1]
    pos=None,  # unused: the state is position-free
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, dict]:
    """One token step; returns (logits [B, V] float32, state), the state
    updated in place (each layer's wkv state by the recurrence itself)."""
    x = layer_norm(params["ln0"], embed(params["embed"], tokens, dtype))
    for i, blk in enumerate(params["blocks"]):
        x = _block_step(cfg, blk, x, state, i)
    x = layer_norm(params["final_norm"], x)
    return (x[:, -1, :] @ params["lm_head"]["w"].to(x.dtype)).float(), state
