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

Every function takes ``tp`` (``tensor_parallel.TensorParallel``; None: the
whole model on this rank): ``init_params`` then keeps this rank's blocks of
the leaves, the layers compute on its heads and MLP columns, the readout on
its vocab block (logits put together over the vocab for serving), and the
KV cache holds the KV heads of its query heads, as ``cache_specs`` places
them where the KV heads split.  Where the stream's length (a prefix joined
on) divides the model axis, its sequence is split over it between blocks
(``TensorParallel.over``): the norms and residual adds act on a rank's rows,
each mixer gathers the sequence, and the final norm's rows are gathered for
the readout; the KV cache keeps a rank's heads over the whole sequence.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import shard_slices, shard_tree
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
    head_split,
    init_norm,
    local_attention,
    mlp,
    remat as remat_block,
    rotated_qkv,
)
from .tensor_parallel import row_leaves


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
    dtype: torch.dtype = torch.float32, tp=None,
) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    from the distributions of ``repro.models.layers``: dense weights
    N(0, 1/fan_in), the embedding N(0, 0.02^2), biases 0, norm scales 1.
    (``jax.random`` draws other numbers: tests carry JAX weights across
    with ``convert.params_from_jax``.)  Kept in ``dtype``, the compute
    dtype, so no use casts them.  Under ``tp`` every rank draws every
    whole leaf in the same order, a block at a time, and keeps its block
    of each: the one-rank model's parameters, sliced."""
    dev = _device(device)

    def keep(tree, spec):
        return tree if tp is None else shard_tree(tree, spec, tp.mesh)

    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def dense(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.randn((d_in, d_out), generator=gen, device=dev, dtype=torch.float32)
        return (w / math.sqrt(d_in)).to(dtype)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=dtype, device=dev)

    d, f = cfg.d_model, cfg.d_ff
    blocks = []
    for i in range(cfg.n_layers):
        attn = init_attention(cfg, dense, dev, dtype)
        ffn = {"w_up": dense(d, f), "w_down": dense(f, d)}
        if cfg.family != "audio":  # hubert uses a plain gelu FFN
            ffn["w_gate"] = dense(d, f)
        if cfg.attn_bias:
            ffn.update(b_up=zeros(f), b_down=zeros(d))
        blocks.append(keep({
            "ln1": init_norm(cfg.norm, d, dev, dtype),
            "attn": attn,
            "ln2": init_norm(cfg.norm, d, dev, dtype),
            "mlp": ffn,
        }, tp and tp.specs["blocks"][i]))
    table = torch.randn((cfg.vocab, d), generator=gen, device=dev, dtype=torch.float32)
    if tp is not None:  # the slice before the scale: one whole fp32 table at a time
        table = table[shard_slices(table.shape, tp.specs["embed"]["table"], tp.mesh)]
    params = {
        "embed": {"table": (table * 0.02).to(dtype)},
        "blocks": blocks,
        "final_norm": init_norm(cfg.norm, d, dev, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep({"w": dense(d, cfg.vocab)}, tp and tp.specs["lm_head"])
    return params


# ------------------------------------------------------------------- forward
def _layer_flags(cfg: ArchConfig) -> list[bool]:
    """Per layer: is it global (full attention)?"""
    if cfg.global_period:
        return [(i + 1) % cfg.global_period == 0 for i in range(cfg.n_layers)]
    return [True] * cfg.n_layers


def norm(cfg: ArchConfig, params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``cfg``'s norm of the stream ``x`` as this rank holds it (its rows
    where ``tp.seq``: the leaves' gradients summed, ``row_leaves``)."""
    return apply_norm(cfg.norm, row_leaves(tp, params), x)


def _block_apply(cfg: ArchConfig, blk: dict, x: torch.Tensor, is_global: bool,
                 tp=None) -> torch.Tensor:
    h = norm(cfg, blk["ln1"], x, tp)
    x = x + attention(blk["attn"], attn_config(cfg), h, is_global, tp)
    h = norm(cfg, blk["ln2"], x, tp)
    return x + mlp(blk["mlp"], h, cfg.act, tp)


def stream_in(params: dict, tokens: torch.Tensor | None, prefix_embeds: torch.Tensor | None,
              dtype: torch.dtype, tp) -> tuple[torch.Tensor, object]:
    """The stream entering the first block, (x, the split for its length):
    the token embeddings, the prefix joined ahead of them; where the joined
    length divides the model axis, this rank's rows of it."""
    if tokens is None:
        if prefix_embeds is None:
            raise ValueError("need tokens and/or prefix_embeds")
        x = prefix_embeds.to(dtype)
        sp = tp.over(x.shape[1]) if tp is not None else None
        return (x if sp is None else sp.leave(x, False)), sp
    n = tokens.shape[1] + (prefix_embeds.shape[1] if prefix_embeds is not None else 0)
    sp = tp.over(n) if tp is not None else None
    if prefix_embeds is None:
        return embed(params["embed"], tokens, dtype, sp), sp
    x = torch.cat([prefix_embeds.to(dtype), embed(params["embed"], tokens, dtype, tp)], dim=1)
    return (x if sp is None else sp.leave(x, False)), sp


def stream_out(cfg: ArchConfig, params: dict, x: torch.Tensor, tp) -> torch.Tensor:
    """The final norm of the stream, whole on every rank (this rank's rows
    normed, then gathered, where ``tp.seq``)."""
    x = norm(cfg, params["final_norm"], x, tp)
    return x if tp is None else tp.enter(x, False)


def forward_hidden(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor | None,  # [B, L]; None for pure-frontend (audio) input
    prefix_embeds: torch.Tensor | None = None,  # [B, P, d] (vlm/audio stub)
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    tp=None,
) -> torch.Tensor:
    """Token (+ prefix) embeddings -> final-norm hidden states [B, L*, d],
    whole on every rank.  ``remat``: recompute each block's activations in
    the backward."""
    x, tp = stream_in(params, tokens, prefix_embeds, dtype, tp)
    for blk, is_global in zip(params["blocks"], _layer_flags(cfg)):
        if remat:
            x = remat_block(_block_apply, cfg, blk, x, is_global, tp)
        else:
            x = _block_apply(cfg, blk, x, is_global, tp)
    return stream_out(cfg, params, x, tp)


def logits_table(cfg: ArchConfig, params: dict) -> torch.Tensor:
    """[V, d] readout table (tied embedding or untied head)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["lm_head"]["w"].T


def split_table(cfg: ArchConfig, params: dict, dtype: torch.dtype, tp) -> tuple:
    """Under ``tp``: (the readout table in ``dtype``, is it this rank's
    vocab block?).  A table split on d (the vocab does not divide: granite,
    internvl2) is put together whole, and every rank reads out alike."""
    name, vocab_dim = ("table", 0) if cfg.tie_embeddings else ("lm_head", 1)
    w = (params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]["w"]).to(dtype)
    split = tp.split_dim(name) == vocab_dim
    if not split:
        w = tp.whole(w, name)
    return (w if vocab_dim == 0 else w.T), split


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
    tp=None,
) -> torch.Tensor:
    """Next-token (or frame-label for encoders) cross entropy; differentiable,
    each block rematerialised in the backward under ``remat``."""
    tokens = batch.get("tokens")
    h = forward_hidden(cfg, params, tokens, batch.get("prefix_embeds"), dtype=dtype,
                       remat=remat, tp=tp)
    if cfg.causal:
        prefix = h.shape[1] - tokens.shape[1]
        h_txt = h[:, prefix:, :]
        inputs = h_txt[:, :-1, :]
        labels = tokens[:, 1:]
    else:
        inputs, labels = h, batch["labels"]
    if tp is None:
        return chunked_cross_entropy(inputs, logits_table(cfg, params), labels, chunk=loss_chunk)
    table, split = split_table(cfg, params, inputs.dtype, tp)
    return chunked_cross_entropy(inputs, table, labels, chunk=loss_chunk,
                                 tp=tp if split else None)


# ------------------------------------------------------------------ serving
def init_kv_cache(
    cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda", tp=None,
) -> dict:
    """Zeroed KV cache in the JAX package's layout, ``{"k", "v"}`` each
    ``[n_layers, B, n_kv, max_seq, hd]``.  ``decode_step`` and ``prefill``
    write into it in place (the JAX package returns a new cache).  Under
    ``tp``, n_kv is the KV heads of this rank's query heads
    (``layers.head_split``; all of them where the heads do not split)."""
    split = head_split(attn_config(cfg), tp)
    n_kv = cfg.n_kv if split is None else split[1][1] - split[1][0]
    shape = (cfg.n_layers, batch, n_kv, max_seq, cfg.hd)
    dev = _device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _readout(cfg: ArchConfig, params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Final norm, then last-position logits [B, V] in float32 (the matmul
    runs in the compute dtype, as in the JAX package); under ``tp`` the
    vocab blocks' logits put together, the same on every rank (``x`` this
    rank's rows where ``tp.seq``)."""
    x = stream_out(cfg, params, x, tp)
    if tp is None:
        return (x[:, -1, :] @ logits_table(cfg, params).to(x.dtype).T).float()
    table, split = split_table(cfg, params, x.dtype, tp)
    logits = x[:, -1, :] @ table.T
    return (tp.gather(logits, -1) if split else logits).float()


def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [B, 1]
    pos: int,  # tokens already in cache
    dtype: torch.dtype = torch.bfloat16,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One autoregressive step; returns (logits [B, V], cache), the cache
    updated in place at ``pos``."""
    x = embed(params["embed"], tokens, dtype, tp)
    acfg = attn_config(cfg)
    for i, (blk, is_global) in enumerate(zip(params["blocks"], _layer_flags(cfg))):
        h = apply_norm(cfg.norm, blk["ln1"], x)
        x = x + attention_decode(blk["attn"], acfg, h, cache["k"][i], cache["v"][i], int(pos),
                                 is_global, tp)
        h = apply_norm(cfg.norm, blk["ln2"], x)
        x = x + mlp(blk["mlp"], h, cfg.act, tp)
    return _readout(cfg, params, x, tp), cache


def prefill(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    cache: dict,
    dtype: torch.dtype = torch.bfloat16,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Prefill the cache with a full prompt: one parallel forward whose
    rotated k and v are written into positions [0, L) of the cache in place.
    Returns (last-position logits, cache).  On the card each full-window
    layer's attention is one K6 launch (under ``tp``, on this rank's heads)."""
    return prefill_with(cfg, params, tokens, cache, dtype, tp,
                        lambda blk, h, tp: mlp(blk["mlp"], h, cfg.act, tp))


def prefill_with(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict,
                 dtype: torch.dtype, tp, ffn) -> tuple[torch.Tensor, dict]:
    """``prefill`` with each block's feed-forward ``ffn(blk, h, tp)`` (the
    MoE family's routed experts in ``moe.prefill``).  Under ``tp`` the
    prompt's sequence is split as ``forward_hidden`` splits it, and each
    layer's k and v, the rank's heads over the whole prompt, come from the
    gathered sequence."""
    x, tp = stream_in(params, tokens, None, dtype, tp)
    l = tokens.shape[1]
    for i, (blk, is_global) in enumerate(zip(params["blocks"], _layer_flags(cfg))):
        h = norm(cfg, blk["ln1"], x, tp)
        attn, acfg, split = local_attention(blk["attn"], attn_config(cfg), tp)
        if tp is not None:
            h = tp.enter(h, split)
        q, k, v = rotated_qkv(attn, acfg, h)
        cache["k"][i, :, :, :l] = k.to(cache["k"].dtype)
        cache["v"][i, :, :, :l] = v.to(cache["v"].dtype)
        y = attention_output(attn, acfg, attention_core(q, k, v, acfg, is_global))
        x = x + (y if tp is None else tp.leave(y, split))
        h = norm(cfg, blk["ln2"], x, tp)
        x = x + ffn(blk, h, tp)
    return _readout(cfg, params, x, tp), cache
