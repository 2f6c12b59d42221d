"""Shared model layers: norms, attention (GQA / sliding-window), MLPs, rotary.

The counterpart of ``repro.models.layers``.  Parameters are plain dicts of
tensors; ``apply``-style functions consume them.  Compute dtype is the
caller's choice (params are cast on entry, a no-op where they are kept in
that dtype); accumulation-sensitive ops (norms, softmax, losses) run in
float32, and bf16 rounds at the places where the JAX package rounds it.

Attention with no sliding window and no logit softcap goes through the
FlashAttention kernel (K6, ``kernels.flash_attention``; its backward kernel
where a gradient is taken) for CUDA tensors;
on the CPU, and for windowed or softcapped attention on either device, it
takes the JAX package's default branches as written (the materialised
``_sdpa``, the query-chunked ``_sdpa_chunked`` past
``ATTN_CHUNK_THRESHOLD``, the windowed mask).  The JAX package's
activation-sharding hooks (``set_activation_sharding``, ``constrain_*``) have
their counterpart in ``tensor_parallel``: ``attention``,
``attention_decode``, ``mlp``, ``embed`` and ``chunked_cross_entropy`` take a
``tp`` (a ``tensor_parallel.TensorParallel``, None for the whole model on
one rank) and compute on this rank's heads, MLP columns and vocab block,
with the collectives of a model axis around them.  Where ``tp.seq`` (the
stream's sequence split over the model group, ``TensorParallel.over``) the
stream comes in as this rank's rows: a mixer gathers the whole sequence at
its entry and leaves its rows at its exit (``TensorParallel.enter`` /
``leave``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention

from .tensor_parallel import row_leaves

Params = dict

# When seq-len exceeds this, the plain attention switches to the chunked
# (loop-over-query-blocks) path so [L, L] score matrices never materialize;
# the JAX package's defaults.
ATTN_CHUNK_THRESHOLD = 2048
ATTN_CHUNK = 1024

_MASKED = -1e30


def _cast(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return p.to(dtype=like.dtype)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Grad is enabled and one of ``tensors`` requires it: where the JAX
    package's ``jax.checkpoint`` would matter (a backward will run)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _tensors(tree) -> list:
    """The tensors of ``tree``: a tensor, or dicts, lists and tuples of them
    at any depth (other leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for sub in tree for t in _tensors(sub)]


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant: the port's ``jax.checkpoint``)
    where a backward will run: a tensor in ``args``, or in their dicts and
    lists (a block's parameters), requires grad.  A plain call otherwise."""
    if needs_grad(*_tensors(args)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------- norms
def rms_norm(params: Params | None, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if params is not None and "scale" in params:
        y = y * params["scale"].float()
    return y.to(x.dtype)


def layer_norm(params: Params | None, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm; with params=None it is OLMo's non-parametric LN."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if params is not None:
        if "scale" in params:
            y = y * params["scale"].float()
        if "bias" in params:
            y = y + params["bias"].float()
    return y.to(x.dtype)


def init_norm(kind: str, d: int, device, dtype=torch.float32) -> Params | None:
    if kind == "rms":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layer":
        return {
            "scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device),
        }
    if kind == "nonparametric":  # OLMo
        return None
    raise ValueError(kind)


def apply_norm(kind: str, params: Params | None, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(params, x)
    return layer_norm(params, x)


# -------------------------------------------------------------------- rotary
def rotary_angles(positions: torch.Tensor, head_dim: int, theta: float):
    half = head_dim // 2
    # made on the device: a host tensor copied over would wait for the card
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs  # [..., L, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, L, D]; cos/sin: [L, D/2] (or broadcastable), cast to x's
    dtype before the products, as the JAX package does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ----------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 1e4
    causal: bool = True
    window: int | None = None  # sliding-window size (None = full)
    qk_norm: bool = False
    bias: bool = False
    logit_softcap: float | None = None


def _qkv(params: Params, cfg: AttnConfig, x: torch.Tensor):
    """q [B, H, L, D], k and v [B, Hkv, L, D]: transposed views of the
    projections (not copies)."""
    b, l, _ = x.shape
    hd = cfg.head_dim
    q = (x @ _cast(params["wq"], x)).reshape(b, l, cfg.n_heads, hd)
    k = (x @ _cast(params["wk"], x)).reshape(b, l, cfg.n_kv, hd)
    v = (x @ _cast(params["wv"], x)).reshape(b, l, cfg.n_kv, hd)
    if "bq" in params:
        q = q + _cast(params["bq"], x).reshape(cfg.n_heads, hd)
        k = k + _cast(params["bk"], x).reshape(cfg.n_kv, hd)
        v = v + _cast(params["bv"], x).reshape(cfg.n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def head_split(cfg: AttnConfig, tp) -> tuple[tuple[int, int], tuple[int, int]] | None:
    """This rank's query heads [q0, q1) and the KV heads [k0, k1) they
    attend with under ``tp``; None where the heads do not split into equal
    GQA-aligned parts (then every rank computes every head)."""
    q = tp.block(cfg.n_heads) if tp is not None else None
    if q is None:
        return None
    per, group = q[1] - q[0], cfg.n_heads // cfg.n_kv
    if per % group and group % per:
        return None
    return q, (q[0] // group, (q[1] - 1) // group + 1)


def local_attention(params: Params, cfg: AttnConfig, tp) -> tuple[Params, AttnConfig, bool]:
    """(the leaves, the config, split?) with which this rank attends.  Split:
    its heads' columns of ``wq``/``wk``/``wv`` and the biases, its heads'
    rows of ``wo``, the qk-norm scales through ``tp.copy``, and the config
    of its heads; the caller puts the input through ``tp.enter(x, True)``
    (``copy``, or the sequence gather) and the output through ``tp.leave``.
    Not split (``tp`` None, or heads that do not split): the whole leaves
    (gathered where the rules split them)."""
    split = head_split(cfg, tp)
    if split is None:
        if tp is None:
            return params, cfg, False
        return {key: leaf if isinstance(leaf, dict) else tp.whole(leaf, f"attn/{key}")
                for key, leaf in params.items()}, cfg, False  # qk-norm: never split
    (q0, q1), (k0, k1) = split
    hd = cfg.head_dim
    where = {"wq": (1, q0, q1), "wk": (1, k0, k1), "wv": (1, k0, k1), "wo": (0, q0, q1),
             "bq": (0, q0, q1), "bk": (0, k0, k1), "bv": (0, k0, k1)}
    out = {}
    for key, leaf in params.items():
        if key in where:
            dim, lo, hi = where[key]
            out[key] = tp.local(leaf, f"attn/{key}", dim, lo * hd, hi * hd)
        else:  # q_norm / k_norm: one [hd] scale that every head uses
            out[key] = {k: tp.local(v, None, 0, 0, v.shape[0]) for k, v in leaf.items()}
    return out, dataclasses.replace(cfg, n_heads=q1 - q0, n_kv=k1 - k0), True


def _softcap(s: torch.Tensor, softcap: float | None) -> torch.Tensor:
    return softcap * torch.tanh(s / softcap) if softcap else s


def _sdpa(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, Hkv, Lk, D]
    v: torch.Tensor,
    causal: bool,
    softcap: float | None = None,
) -> torch.Tensor:
    """The materialised attention of full-window layers (the JAX package's
    ``_sdpa`` as ``attention`` calls it: no window, no query offset)."""
    b, h, lq, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    qg = q.reshape(b, hkv, group, lq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) / math.sqrt(d)
    s = _softcap(s, softcap)
    if causal:
        pos_q = torch.arange(lq, device=q.device)
        mask = pos_q[:, None] >= torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, h, lq, d).to(q.dtype)


def _sdpa_chunked(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, Hkv, L, D]
    v: torch.Tensor,
    causal: bool,
    eff_window: int | None,
    chunk: int,
    softcap: float | None,
) -> torch.Tensor:
    """A loop over query blocks: peak score memory is [B, H, chunk, L]
    instead of [B, H, L, L].  Each chunk body is rematerialised in the
    backward (``remat``), as the JAX package checkpoints it, so the
    backward too holds one chunk's scores at a time."""
    b, h, l, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    qg = q.reshape(b, hkv, group, l, d)
    kf = k.float()
    vf = v.float()
    k_pos = torch.arange(l, device=q.device)
    scale = 1.0 / math.sqrt(d)

    def body(qc: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, i: int) -> torch.Tensor:
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc.float(), kf) * scale
        s = _softcap(s, softcap)
        q_pos = i * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((chunk, l), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if eff_window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < eff_window
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhgqk,bhkd->bhgqd", p, vf).to(q.dtype)

    outs = [remat(body, qg[:, :, :, i * chunk:(i + 1) * chunk], kf, vf, i)
            for i in range(l // chunk)]
    return torch.cat(outs, dim=3).reshape(b, h, l, d)


def _windowed(q, k, v, cfg: AttnConfig, eff_window: int) -> torch.Tensor:
    """The JAX package's masked branch for sliding-window layers."""
    b, _, l, hd = q.shape
    hkv, group = cfg.n_kv, cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, hkv, group, l, hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) / math.sqrt(hd)
    s = _softcap(s, cfg.logit_softcap)
    pos = torch.arange(l, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    mask &= (pos[:, None] - pos[None, :]) < eff_window
    s = torch.where(mask, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hkv * group, l, hd).to(q.dtype)


def attention_core(
    q: torch.Tensor,  # [B, H, L, D], rotated
    k: torch.Tensor,  # [B, Hkv, L, D], rotated
    v: torch.Tensor,
    cfg: AttnConfig,
    is_global: bool = True,
) -> torch.Tensor:
    """Attention of rotated q, k, v; [B, H, L, D] in q's dtype.

    Full-window, uncapped attention on the card is K6, at any L; everything
    else takes the JAX package's default branches."""
    l = q.shape[2]
    if q.is_cuda and cfg.window is None and cfg.logit_softcap is None:
        return flash_attention(q, k, v, causal=cfg.causal)
    eff_window = None
    if cfg.window is not None:
        eff_window = l if is_global else cfg.window
    if l > ATTN_CHUNK_THRESHOLD and l % ATTN_CHUNK == 0:
        return _sdpa_chunked(q, k, v, cfg.causal, eff_window, ATTN_CHUNK, cfg.logit_softcap)
    if eff_window is None:
        return _sdpa(q, k, v, cfg.causal, softcap=cfg.logit_softcap)
    return _windowed(q, k, v, cfg, eff_window)


def attention(
    params: Params,
    cfg: AttnConfig,
    x: torch.Tensor,  # [B, L, d_model]
    is_global: bool = True,
    tp=None,
) -> torch.Tensor:
    """Full attention; ``is_global=False`` applies cfg.window (Gemma-style
    local layers).  Under ``tp``, this rank's heads (``local_attention``),
    over the whole sequence gathered from the ranks' rows where ``tp.seq``."""
    params, cfg, split = local_attention(params, cfg, tp)
    if tp is not None:
        x = tp.enter(x, split)
    q, k, v = rotated_qkv(params, cfg, x)
    y = attention_output(params, cfg, attention_core(q, k, v, cfg, is_global))
    return y if tp is None else tp.leave(y, split)


def attention_output(params: Params, cfg: AttnConfig, out: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] heads -> [B, L, d_model] through ``wo``."""
    b, _, l, _ = out.shape
    y = out.transpose(1, 2).reshape(b, l, cfg.n_heads * cfg.head_dim)
    return y @ _cast(params["wo"], y)


def rotated_qkv(params: Params, cfg: AttnConfig, x: torch.Tensor):
    """``_qkv`` with rotary embeddings at positions 0..L-1 on q and k."""
    q, k, v = _qkv(params, cfg, x)
    cos, sin = rotary_angles(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                             cfg.rope_theta)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def attention_decode(
    params: Params,
    cfg: AttnConfig,
    x: torch.Tensor,  # [B, 1, d_model] — one new token
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    pos: int,  # current position (number of tokens already cached)
    is_global: bool = True,
    tp=None,
) -> torch.Tensor:
    """One decode step against a KV cache; returns y.  Writes the new k and
    v into the caches at ``pos`` in place.  ``is_global`` lifts the sliding
    window for Gemma-style global layers.  Under ``tp`` the caches hold the
    KV heads of this rank's query heads (``local_attention``)."""
    params, cfg, split = local_attention(params, cfg, tp)
    if tp is not None:
        x = tp.enter(x, split)
    b = x.shape[0]
    q, k, v = _qkv(params, cfg, x)  # q [B,H,1,D], k/v [B,Hkv,1,D]
    cos, sin = rotary_angles(torch.full((1,), pos, device=x.device), cfg.head_dim,
                             cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k_cache[:, :, pos] = k[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v[:, :, 0].to(v_cache.dtype)
    s_max = k_cache.shape[2]
    hkv, group = cfg.n_kv, cfg.n_heads // cfg.n_kv
    qg = q.reshape(b, hkv, group, 1, cfg.head_dim)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k_cache.float()) / math.sqrt(cfg.head_dim)
    s = _softcap(s, cfg.logit_softcap)
    k_pos = torch.arange(s_max, device=x.device)
    valid = k_pos <= pos
    if cfg.window is not None and not is_global:
        valid &= (pos - k_pos) < cfg.window
    s = torch.where(valid, s, torch.full_like(s, _MASKED))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.float())
    out = out.reshape(b, cfg.n_heads, 1, cfg.head_dim).to(x.dtype)
    y = out.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    y = y @ _cast(params["wo"], x)
    return y if tp is None else tp.leave(y, split)


# ---------------------------------------------------------------------- MLPs
def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation: "gelu" is that form too
    return {
        "silu": F.silu,
        "gelu": lambda u: F.gelu(u, approximate="tanh"),
        "gelu_tanh": lambda u: F.gelu(u, approximate="tanh"),
        "relu": F.relu,
    }[name]


def local_mlp(params: Params, tp, name: str = "mlp") -> tuple[Params, bool]:
    """(the leaves, split?) with which this rank runs the MLP at ``name`` in
    its block (``mlp``; MoE's shared expert ``shared``): its block of the
    d_ff columns of ``w_up``/``w_gate``/``b_up`` and rows of ``w_down``
    where d_ff splits (the caller then puts the input through ``tp.enter``
    and the output, before ``b_down``, through ``tp.leave``), else the
    whole leaves."""
    cols = tp.block(tp.leaf_split[f"{name}/w_up"][0][1]) if tp is not None else None
    if cols is None:
        if tp is None:
            return params, False
        return {key: tp.whole(leaf, f"{name}/{key}") for key, leaf in params.items()}, False
    dims = {"w_up": 1, "w_gate": 1, "b_up": 0, "w_down": 0}
    return {key: (tp.local(leaf, f"{name}/{key}", dims[key], *cols) if key in dims
                  else tp.whole(leaf, f"{name}/{key}"))
            for key, leaf in params.items()}, True


def mlp(params: Params, x: torch.Tensor, act: str = "silu", tp=None) -> torch.Tensor:
    """The MLP; under ``tp`` on this rank's d_ff columns (``local_mlp``),
    the stream entering and leaving as ``attention``'s; ``b_down`` added
    once, on the rows the stream leaves with."""
    params, split = local_mlp(params, tp)
    if tp is not None:
        x = tp.enter(x, split)
    a = _act(act)
    up = x @ _cast(params["w_up"], x)
    if "b_up" in params:
        up = up + _cast(params["b_up"], x)
    if "w_gate" in params:
        h = a(x @ _cast(params["w_gate"], x)) * up
    else:
        h = a(up)
    y = h @ _cast(params["w_down"], x)
    if tp is not None:
        y = tp.leave(y, split)
    if "b_down" in params:
        y = y + _cast(row_leaves(tp, params["b_down"]), x)
    return y


# ----------------------------------------------------------------- embedding
def embed(params: Params, tokens: torch.Tensor, dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """The tokens' rows of the table.  Under ``tp``: a vocab-split table
    looks up the rows of its block (others 0) and sums over the model
    group; a table split on d looks up its columns and puts them together;
    where ``tp.seq`` this rank keeps its positions' rows (the vocab-split
    sum reduce-scattered)."""
    table = params["table"].to(dtype)
    split = tp.split_dim("table") if tp is not None else None
    if split is None:
        return table[tokens] if tp is None else tp.leave(table[tokens], False)
    if split == 1:
        return tp.leave(tp.gather(table[tokens], -1), False)
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return tp.leave(torch.where(inside[..., None], rows, torch.zeros_like(rows)), True)


def chunked_cross_entropy(
    x: torch.Tensor,  # [B, L, d] final hidden states
    emb_table: torch.Tensor,  # [V, d] (tied) or lm_head [d, V] passed transposed
    labels: torch.Tensor,  # [B, L]
    chunk: int = 512,
    logit_softcap: float | None = None,
    tp=None,
) -> torch.Tensor:
    """Mean cross-entropy over labels >= 0, one sequence chunk of logits at
    a time so [B, L, V] never materialises; each chunk's logits are
    rematerialised in the backward (``remat``), as the JAX package
    checkpoints them.  The count of valid labels stays on the device.

    Under ``tp`` the table is this rank's vocab block (rows [r * V/n, (r+1)
    * V/n)): the log-partition is the group's MAX of the row max plus the
    log of the SUM of every block's exponent sum, and the gold logit the SUM
    of the one block that holds it (0 elsewhere)."""
    l = x.shape[1]
    chunk = min(chunk, l)
    if tp is not None:
        x = tp.copy(x)
        lo = tp.rank * emb_table.shape[0]

    def chunk_loss(xc: torch.Tensor, table: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
        logits = (xc @ table.T).float()
        logits = _softcap(logits, logit_softcap)
        if tp is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yc.clamp(min=0).long()[..., None])[..., 0]
        else:
            m = tp.max(logits.max(dim=-1).values)
            logz = m + torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
            local = yc.long() - lo
            inside = (local >= 0) & (local < logits.shape[-1])
            picked = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])
            gold = tp.reduce(torch.where(inside, picked[..., 0], torch.zeros_like(logz)))
        return torch.where(yc >= 0, logz - gold, torch.zeros_like(logz)).sum()

    table = emb_table.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, l, chunk):
        total = total + remat(chunk_loss, x[:, c0:c0 + chunk], table, labels[:, c0:c0 + chunk])
    count = (labels >= 0).sum()
    return total / torch.clamp(count, min=1)
