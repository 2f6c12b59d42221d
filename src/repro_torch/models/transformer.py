"""Dense decoder/encoder transformer (covers command-r-plus, gemma3, olmo,
granite, internvl2 backbone, hubert encoder): the counterpart of
``repro.models.transformer``: forward, loss with gradients, and serving.

Parameters are a dict: ``embed`` (``{"table": [V, d]}``), ``blocks`` (a list
of per-layer dicts, where the JAX package stacks them on axis 0 for
``lax.scan``), ``final_norm`` and, untied, ``lm_head``.  Layers run in a
Python loop.  Gemma-style 5:1 local:global patterns take one Python bool per
layer.  VLM/audio frontends are stubs: precomputed ``prefix_embeds`` are
concatenated ahead of the token embeddings, as in the JAX package.

``forward_hidden`` and ``loss_fn`` take ``remat`` (default True, as in the
JAX package): each block runs under ``torch.utils.checkpoint`` where a
backward will run, the port's ``jax.checkpoint`` of the scanned body, so a
step holds one block's activations at a time and runs each block's forward
twice (K6 included).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.mapreduce.executor import _device

from .layers import (
    AttnConfig,
    apply_norm,
    attention,
    attention_core,
    attention_decode,
    attention_output,
    chunked_cross_entropy,
    embed,
    init_norm,
    mlp,
    remat as remat_block,
    rotated_qkv,
)


def attn_config(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv,
        head_dim=cfg.hd,
        rope_theta=cfg.rope_theta,
        causal=cfg.causal,
        window=cfg.window or None,
        qk_norm=cfg.qk_norm,
        bias=cfg.attn_bias,
    )


# ---------------------------------------------------------------------- init
def init_attention(cfg: ArchConfig, dense, device: torch.device, dtype: torch.dtype) -> dict:
    """One layer's attention parameters: ``dense(d_in, d_out)`` draws wq,
    wk, wv and wo in that order; biases 0 and qk-norm scales 1 in
    ``dtype``."""
    d, hd = cfg.d_model, cfg.hd
    attn = {
        "wq": dense(d, cfg.n_heads * hd),
        "wk": dense(d, cfg.n_kv * hd),
        "wv": dense(d, cfg.n_kv * hd),
        "wo": dense(cfg.n_heads * hd, d),
    }
    if cfg.attn_bias:
        attn.update({name: torch.zeros(n * hd, dtype=dtype, device=device)
                     for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv), ("bv", cfg.n_kv))})
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
        attn["k_norm"] = {"scale": torch.ones(hd, dtype=dtype, device=device)}
    return attn


def init_params(
    cfg: ArchConfig, seed: int, device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    from the distributions of ``repro.models.layers``: dense weights
    N(0, 1/fan_in), the embedding N(0, 0.02^2), biases 0, norm scales 1.
    (``jax.random`` draws other numbers: tests carry JAX weights across
    with ``convert.params_from_jax``.)  Kept in ``dtype``, the compute
    dtype, so no use casts them."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def dense(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.randn((d_in, d_out), generator=gen, device=dev, dtype=torch.float32)
        return (w / math.sqrt(d_in)).to(dtype)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=dtype, device=dev)

    d, f = cfg.d_model, cfg.d_ff
    blocks = []
    for _ in range(cfg.n_layers):
        attn = init_attention(cfg, dense, dev, dtype)
        ffn = {"w_up": dense(d, f), "w_down": dense(f, d)}
        if cfg.family != "audio":  # hubert uses a plain gelu FFN
            ffn["w_gate"] = dense(d, f)
        if cfg.attn_bias:
            ffn.update(b_up=zeros(f), b_down=zeros(d))
        blocks.append({
            "ln1": init_norm(cfg.norm, d, dev, dtype),
            "attn": attn,
            "ln2": init_norm(cfg.norm, d, dev, dtype),
            "mlp": ffn,
        })
    table = torch.randn((cfg.vocab, d), generator=gen, device=dev, dtype=torch.float32)
    params = {
        "embed": {"table": (table * 0.02).to(dtype)},
        "blocks": blocks,
        "final_norm": init_norm(cfg.norm, d, dev, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense(d, cfg.vocab)}
    return params


# ------------------------------------------------------------------- forward
def _layer_flags(cfg: ArchConfig) -> list[bool]:
    """Per layer: is it global (full attention)?"""
    if cfg.global_period:
        return [(i + 1) % cfg.global_period == 0 for i in range(cfg.n_layers)]
    return [True] * cfg.n_layers


def _block_apply(cfg: ArchConfig, blk: dict, x: torch.Tensor, is_global: bool) -> torch.Tensor:
    h = apply_norm(cfg.norm, blk["ln1"], x)
    x = x + attention(blk["attn"], attn_config(cfg), h, is_global)
    h = apply_norm(cfg.norm, blk["ln2"], x)
    return x + mlp(blk["mlp"], h, cfg.act)


def forward_hidden(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor | None,  # [B, L]; None for pure-frontend (audio) input
    prefix_embeds: torch.Tensor | None = None,  # [B, P, d] (vlm/audio stub)
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
) -> torch.Tensor:
    """Token (+ prefix) embeddings -> final-norm hidden states [B, L*, d].
    ``remat``: recompute each block's activations in the backward."""
    if tokens is None:
        if prefix_embeds is None:
            raise ValueError("need tokens and/or prefix_embeds")
        x = prefix_embeds.to(dtype)
    else:
        x = embed(params["embed"], tokens, dtype)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    for blk, is_global in zip(params["blocks"], _layer_flags(cfg)):
        if remat:
            x = remat_block(_block_apply, cfg, blk, x, is_global)
        else:
            x = _block_apply(cfg, blk, x, is_global)
    return apply_norm(cfg.norm, params["final_norm"], x)


def logits_table(cfg: ArchConfig, params: dict) -> torch.Tensor:
    """[V, d] readout table (tied embedding or untied head)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["lm_head"]["w"].T


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
) -> torch.Tensor:
    """Next-token (or frame-label for encoders) cross entropy; differentiable,
    each block rematerialised in the backward under ``remat``."""
    tokens = batch.get("tokens")
    h = forward_hidden(cfg, params, tokens, batch.get("prefix_embeds"), dtype=dtype,
                       remat=remat)
    if cfg.causal:
        prefix = h.shape[1] - tokens.shape[1]
        h_txt = h[:, prefix:, :]
        inputs = h_txt[:, :-1, :]
        labels = tokens[:, 1:]
    else:
        inputs, labels = h, batch["labels"]
    return chunked_cross_entropy(inputs, logits_table(cfg, params), labels, chunk=loss_chunk)


# ------------------------------------------------------------------ serving
def init_kv_cache(
    cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> dict:
    """Zeroed KV cache in the JAX package's layout, ``{"k", "v"}`` each
    ``[n_layers, B, n_kv, max_seq, hd]``.  ``decode_step`` and ``prefill``
    write into it in place (the JAX package returns a new cache)."""
    shape = (cfg.n_layers, batch, cfg.n_kv, max_seq, cfg.hd)
    dev = _device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _readout(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then last-position logits [B, V] in float32 (the matmul
    runs in the compute dtype, as in the JAX package)."""
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return (x[:, -1, :] @ logits_table(cfg, params).to(x.dtype).T).float()


def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [B, 1]
    pos: int,  # tokens already in cache
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, dict]:
    """One autoregressive step; returns (logits [B, V], cache), the cache
    updated in place at ``pos``."""
    x = embed(params["embed"], tokens, dtype)
    acfg = attn_config(cfg)
    for i, (blk, is_global) in enumerate(zip(params["blocks"], _layer_flags(cfg))):
        h = apply_norm(cfg.norm, blk["ln1"], x)
        x = x + attention_decode(blk["attn"], acfg, h, cache["k"][i], cache["v"][i], int(pos),
                                 is_global)
        h = apply_norm(cfg.norm, blk["ln2"], x)
        x = x + mlp(blk["mlp"], h, cfg.act)
    return _readout(cfg, params, x), cache


def prefill(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    cache: dict,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, dict]:
    """Prefill the cache with a full prompt: one parallel forward whose
    rotated k and v are written into positions [0, L) of the cache in place.
    Returns (last-position logits, cache).  On the card each full-window
    layer's attention is one K6 launch."""
    x = embed(params["embed"], tokens, dtype)
    acfg = attn_config(cfg)
    l = tokens.shape[1]
    for i, (blk, is_global) in enumerate(zip(params["blocks"], _layer_flags(cfg))):
        h = apply_norm(cfg.norm, blk["ln1"], x)
        q, k, v = rotated_qkv(blk["attn"], acfg, h)
        cache["k"][i, :, :, :l] = k.to(cache["k"].dtype)
        cache["v"][i, :, :, :l] = v.to(cache["v"].dtype)
        x = x + attention_output(blk["attn"], acfg, attention_core(q, k, v, acfg, is_global))
        h = apply_norm(cfg.norm, blk["ln2"], x)
        x = x + mlp(blk["mlp"], h, cfg.act)
    return _readout(cfg, params, x), cache
