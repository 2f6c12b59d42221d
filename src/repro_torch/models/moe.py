"""Mixture-of-Experts transformer with SharesSkew expert dispatch: the
counterpart of ``repro.models.moe``.

The paper's technique transferred (DESIGN.md §2): token->expert routing is a
skewed 2-way join ``Tokens(t, e) ⋈ Experts(e, W_e)``.  Hot experts are the
heavy hitters; tokens headed to a hot expert are hash-partitioned across
that expert's replica slots (``plan_replica_slots`` is the paper's §4.2
reducer-allocation rule with q = capacity), as SharesSkew spreads heavy
hitters' tuples.

Dispatch is sort-based and static-shaped: S = E + extra_slots slots of
capacity ``cap`` each, fixed by the shapes; *which* expert each replica
slot serves is a run-time value from the batch's expert histogram.  The
integer half (``dispatch``) bins every choice with the join engine's
``group_by_reducer``.  The JAX package bins each sequence (one dispatch
group) apart under ``vmap`` and its replica slots in a second call; the
port bins all g groups and all S slots in one call over S·g reducers,
numbered slot-major (reducer ``slot * g + group``).  A bin keeps its
choices in their order within the group either way, so each (group, slot)
bin, its load and its drops are the JAX package's.  The slot-major layout
makes the dispatch buffer [S, g·cap, d], so each expert projection is one
batched GEMM over the E primary slots and one over the replica slots.

The combine gathers each choice's expert output through the inverse of the
bin map (``Dispatch.pos``) and sums a token's k choices in a fixed order;
the JAX package's scatter-add sums them in another order, a rounding
difference.  The dispatch and the combine are autograd Functions whose
backward is again a gather through the other map (a token's gradient is
the sum of its k buffer rows', a buffer row's comes from its one choice).
The replica slots' weights are gathered by ``_SlotWeights``, whose
backward adds each slot's gradient to its expert's one slot at a time.  So
every float sum runs in a fixed order, and two train steps from one state
agree bit for bit.

Parameters are the JAX package's tree with ``blocks`` a list: per layer
``ln1``, ``attn``, ``ln2``, ``router`` [d, E], ``experts`` (``w_gate``,
``w_up`` [E, d, f], ``w_down`` [E, f, d]) and, with a shared expert,
``shared`` (a gated MLP of width ``d_ff``) and ``shared_gate`` [d, 1].
Attention is the dense family's (K6 on the card, K6b under a gradient).

Every function takes ``tp`` (``tensor_parallel.TensorParallel``; None: the
whole model on this rank), the counterpart of the JAX package's
``constrain_moe_dispatch`` under ``--mesh prod``: attention on this rank's
heads, the shared expert on its MLP columns, the embedding and readout on
its vocab block, as the dense family splits them; the router and
``shared_gate`` are used whole.  The stream enters ``moe_ffn`` whole on
every rank of a model group (where its sequence is split over the group,
gathered first: ``TensorParallel.enter``), so every rank computes the same
routing and the same integer dispatch, and no all-to-all is needed: a rank
computes the buffer rows of its own slots (its experts' primary slots and
its share of the replica slots, whose weights ``TensorParallel.fetch_slots``
shares), or, where the experts do not divide the axis, every slot on its
block of the expert width; its weighted partial sums, with the shared
expert's, join one ``reduce`` (a reduce-scatter to the rank's rows where
the sequence is split: ``leave``).  The tokens and the top-k weights go
through ``copy`` first (the sequence gather, whose gradient is
reduce-scattered, where the sequence is split; the router's use of it then
goes through ``TensorParallel.alike``), since a rank's dispatch and combine
read only its own rows of them; the aux loss is computed alike on every
rank and is not summed over the group.
Not ported: ``expert_pad`` and the ``REPRO_EXPERT_PAD`` environment knob,
which pad the expert dim to tile a TPU mesh axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import shard_slices, shard_tree
from repro_torch.mapreduce.executor import _device
from repro_torch.mapreduce.hashing import mix32_torch
from repro_torch.mapreduce.local_join import group_by_reducer

from .layers import (
    apply_norm,
    attention,
    attention_decode,
    chunked_cross_entropy,
    embed,
    init_norm,
    local_mlp,
    mlp,
    remat as remat_block,
)
from .transformer import _layer_flags, _readout, attn_config, init_attention, logits_table
from .transformer import init_kv_cache  # noqa: F401  (the dense family's cache)
from .transformer import norm, prefill_with, split_table, stream_in, stream_out
from .tensor_parallel import _Sum, row_leaves

REPLICA_SEED = 0xD15C  # mix32 seed that spreads a hot expert's tokens over its replicas


# ----------------------------------------------------------------------- init
def init_params(
    cfg: ArchConfig, seed: int, device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32, tp=None,
) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    from the distributions of ``repro.models.moe.init_params``: N(0, 1/n)
    with n the leading dim (so the experts' ``w_gate`` and ``w_up`` take
    1/E, as ``_dense_init`` draws them there; ``w_down`` 1/f), the embedding
    N(0, 0.02^2), biases 0, norm scales 1.  Each tensor is drawn in fp32 and
    cast to ``dtype`` at once, so a bf16 model never holds an fp32 copy.
    Under ``tp`` every rank draws every whole leaf in the same order, a
    block at a time, and keeps its block of each: the one-rank model's
    parameters, sliced."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def keep(tree, spec):
        return tree if tp is None else shard_tree(tree, spec, tp.mesh)

    def dense(*shape: int, fan: int | None = None) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w / math.sqrt(fan or shape[0])).to(dtype)

    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    blocks = []
    for i in range(cfg.n_layers):
        blk = {
            "ln1": init_norm(cfg.norm, d, dev, dtype),
            "attn": init_attention(cfg, dense, dev, dtype),
            "ln2": init_norm(cfg.norm, d, dev, dtype),
            "router": dense(d, e),
            "experts": {
                "w_gate": dense(e, d, fe),
                "w_up": dense(e, d, fe),
                "w_down": dense(e, fe, d, fan=fe),
            },
        }
        if cfg.n_shared:
            blk["shared"] = {"w_up": dense(d, cfg.d_ff), "w_down": dense(cfg.d_ff, d),
                             "w_gate": dense(d, cfg.d_ff)}
            blk["shared_gate"] = dense(d, 1)
        blocks.append(keep(blk, tp and tp.specs["blocks"][i]))
    table = torch.randn((cfg.vocab, d), generator=gen, device=dev, dtype=torch.float32)
    if tp is not None:  # the slice before the scale: one whole fp32 table at a time
        table = table[shard_slices(table.shape, tp.specs["embed"]["table"], tp.mesh)]
    params = {
        "embed": {"table": (table * 0.02).to(dtype)},
        "blocks": blocks,
        "final_norm": init_norm(cfg.norm, d, dev, dtype),
    }
    del table
    if not cfg.tie_embeddings:
        params["lm_head"] = keep({"w": dense(d, cfg.vocab)}, tp and tp.specs["lm_head"])
    return params


# ----------------------------------------------------- SharesSkew replica plan
def plan_replica_slots(
    counts: torch.Tensor,  # [E] tokens routed to each expert this batch
    capacity: int,
    n_experts: int,
    extra_slots: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Allocate ``extra_slots`` replica slots to overloaded experts.

    Returns (slot_expert [E + extra], replica_count [E], extra_base [E]),
    int32.  need_e = ceil(count_e / C) - 1 replicas beyond the primary;
    grants go to the neediest experts first (a stable order, so ties go to
    the lower expert, as ``jnp.argsort`` orders them), truncated to the
    budget.  Replica slots past the grants serve the last expert, E - 1, as
    ``jnp.repeat(..., total_repeat_length=extra_slots)`` pads."""
    e = n_experts
    dev = counts.device
    need = torch.clamp((counts.long() + capacity - 1) // capacity - 1, min=0)
    order = torch.argsort(-need, stable=True)
    sorted_need = need[order]
    cum = torch.cumsum(sorted_need, 0)
    grant = torch.empty_like(need)
    grant[order] = torch.clamp(sorted_need - torch.clamp(cum - extra_slots, min=0), min=0)
    cum_grant = torch.cumsum(grant, 0)
    extra_base = e + cum_grant - grant
    # replica slot j serves the first expert whose cumulative grant exceeds j
    j = torch.arange(extra_slots, device=dev)
    slot_x = torch.clamp(torch.searchsorted(cum_grant, j, right=True), max=e - 1)
    slot_expert = torch.cat([torch.arange(e, device=dev), slot_x])
    return slot_expert.int(), (1 + grant).int(), extra_base.int()


def _counts(index: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64 occurrences of each value of ``index`` in [0, n): integer
    adds, so the order does not matter, and no host sync (CUDA
    ``bincount`` reads its input's max on the host)."""
    return torch.zeros(n, dtype=torch.int64, device=index.device).index_add_(
        0, index, torch.ones_like(index))


# -------------------------------------------------------------- the dispatch
def _spans_ranks(group) -> bool:
    return group is not None and group.size() > 1


def data_parallel_batch(topi: torch.Tensor, n_experts: int, group=None):
    """What the replica plan and the aux loss need of the global batch:
    (each expert's choices [E] int64, the dispatch groups, the index of this
    batch's first group).  For no group, or a group of one rank, that is
    this batch: its counts, its g, 0.  Where the batch is this rank's share
    of a data-parallel ``group`` of more than one rank, it is the ranks'
    batches together, from one SUM ``all_reduce`` of [counts, g at this
    rank's place] (the last two items then 0-d int64 tensors)."""
    e, g = n_experts, topi.shape[0]
    counts = _counts(topi.reshape(-1), e)
    if not _spans_ranks(group):
        return counts, g, 0
    local = torch.zeros(e + group.size(), dtype=torch.int64, device=topi.device)
    local[:e] = counts
    local[e + group.rank()] = g
    dist.all_reduce(local, group=group)
    return local[:e], local[e:].sum(), local[e:e + group.rank()].sum()


def assign_slots(
    flat_e: torch.Tensor, n_experts: int, cap: int, extra_slots: int, dp=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Each choice's slot and the expert each slot serves.

    ``flat_e`` [g, n] holds each choice's expert.  Returns (slot [g, n]
    int64, slot_expert [E + extra] int32, or None without replica slots).
    A choice of an expert granted r replicas goes to its primary slot e or
    to its replica slot ``extra_base[e] + r' - 1`` by r' = mix32(global
    choice index, REPLICA_SEED) % (1 + r); the plan is for g groups of
    ``cap`` rows a slot.  ``dp`` (``data_parallel_batch``, this batch's when
    None): the batch whose counts and groups the plan is for, and where this
    batch's choices stand in it, so a rank's share of a data-parallel batch
    is planned as the JAX package's SPMD host mesh plans the whole."""
    if extra_slots == 0:
        return flat_e, None
    g, n = flat_e.shape
    e = n_experts
    counts, groups, first = dp if dp is not None else data_parallel_batch(flat_e, e)
    gid = ((first + torch.arange(g, device=flat_e.device))[:, None] * n
           + torch.arange(n, device=flat_e.device))
    slot_expert, replica_count, extra_base = plan_replica_slots(counts, cap * groups, e,
                                                                extra_slots)
    r = mix32_torch(gid, REPLICA_SEED) % replica_count.long()[flat_e]
    return torch.where(r == 0, flat_e, extra_base.long()[flat_e] + r - 1), slot_expert


@dataclasses.dataclass
class Dispatch:
    """What ``moe_ffn`` needs of the integer half, for g groups of tg
    tokens, k choices each (choice c of a group is its token c // k's
    (c % k)-th expert).  Buffer row ``(slot * g + group) * cap + rank``
    holds a slot's rank-th choice from the group (slot-major)."""

    slot_expert: torch.Tensor | None  # [S] int32: the expert each slot serves; None: no replicas
    loads: torch.Tensor  # [S, g] int32: arrivals before capacity
    choice: torch.Tensor  # [S*g*cap] each buffer row's choice (group*tg*k + c); -1 if empty
    src: torch.Tensor  # [S*g*cap] each buffer row's token (group*tg + t); -1 if empty
    pos: torch.Tensor  # [g*tg*k] each choice's buffer row; -1 where dropped


def dispatch(topi: torch.Tensor, n_experts: int, cap: int, extra_slots: int = 0,
             dp=None) -> Dispatch:
    """Bin ``topi`` [g, tg, k] (each token's experts) into S = n_experts +
    extra_slots slots of ``cap`` rows per group, each choice in the slot
    ``assign_slots`` gives it (``dp``: as its)."""
    g, tg, k = topi.shape
    n = tg * k
    s = n_experts + extra_slots
    dev = topi.device
    slot, slot_expert = assign_slots(topi.reshape(g, n).long(), n_experts, cap, extra_slots, dp)
    c = torch.arange(n, device=dev)
    reducer = slot * g + torch.arange(g, device=dev)[:, None]
    bins, valid, loads, _ = group_by_reducer(reducer.reshape(-1), c.repeat(g)[:, None], s * g,
                                             cap)
    # the inverse of the bin map: each kept choice's buffer row
    row = torch.arange(s * g * cap, device=dev)
    flat_valid = valid.reshape(-1)
    choice = torch.where(flat_valid, (row // cap) % g * n + bins.reshape(-1), -1)
    pos = torch.full((g * n + 1,), -1, dtype=torch.long, device=dev)
    pos[torch.where(flat_valid, choice, g * n)] = torch.where(flat_valid, row, -1)
    return Dispatch(slot_expert=slot_expert, loads=loads.reshape(s, g), choice=choice,
                    src=torch.where(flat_valid, choice // k, -1), pos=pos[:g * n])


def route(blk: dict, x: torch.Tensor, k: int):
    """(probs [.., E] fp32, normalised top-k weights, top-k experts [.., k]).
    ``jax.lax.top_k`` breaks ties by the lower index and ``torch.topk`` may
    not (bf16 router logits tie often), so the top k come from a stable
    descending sort."""
    logits = (x @ blk["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw = vals[..., :k]
    return probs, topw / topw.sum(-1, keepdim=True), idx[..., :k]


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows of the [n, d] ``table`` at ``index``, zero rows where it is -1:
    one gather from the table with a zero row appended."""
    n, d = table.shape
    padded = torch.cat([table, table.new_zeros(1, d)])
    return padded.index_select(0, torch.where(index >= 0, index, n))


def _summed_rows(table: torch.Tensor, index: torch.Tensor, weight: torch.Tensor,
                 fan: int) -> torch.Tensor:
    """[m, d]: row i is the sum over j < ``fan`` of weight[i*fan + j] times
    table[index[i*fan + j]], one product accumulated in fp32; an index of
    -1 must come with weight 0."""
    d = table.shape[1]
    rows = table.index_select(0, index.clamp(min=0)).view(-1, fan, d)
    return torch.bmm(weight.view(-1, 1, fan).to(table.dtype), rows).view(-1, d)


class _Dispatch(torch.autograd.Function):
    """Tokens x [T, d] -> the dispatch buffer [R, d]: row r holds
    x[src[r]], zero where src[r] is -1.  Backward: a token's gradient is
    the sum of its k choices' rows, which ``pos`` names; gathers and a
    product, so no float add goes through a scatter or an atomic."""

    @staticmethod
    def forward(ctx, x, src, pos, k: int):
        ctx.save_for_backward(pos)
        ctx.k = k
        return _rows(x, src)

    @staticmethod
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        return _summed_rows(grad, pos, (pos >= 0).to(grad.dtype), ctx.k), None, None, None


class _Combine(torch.autograd.Function):
    """Expert outputs y [R, d] back to the tokens: out[t] is the sum over
    its k choices of w[t*k + j] times y[pos[t*k + j]] (a dropped choice
    has pos -1 and weight 0, and adds 0 times a finite row).  Backward:
    each buffer row's gradient from the one choice that reads it
    (``choice``), the weights' from the rows' products with out's."""

    @staticmethod
    def forward(ctx, y, w, pos, choice, k: int):
        ctx.save_for_backward(y, w, pos, choice)
        ctx.k = k
        return _summed_rows(y, pos, w, k)

    @staticmethod
    def backward(ctx, grad):
        y, w, pos, choice = ctx.saved_tensors
        k, d = ctx.k, y.shape[1]
        grad_y = _rows((w.view(-1, k, 1) * grad.reshape(-1, 1, d)).view(-1, d), choice)
        rows = y.index_select(0, pos.clamp(min=0)).view(-1, k, d)
        grad_w = torch.bmm(rows, grad.reshape(-1, d, 1)).view(-1)
        return grad_y, grad_w, None, None, None


class _SlotWeights(torch.autograd.Function):
    """An expert weight w [E, ...] -> w[sx] [X, ...], the weights of the
    experts that the replica slots ``sx`` serve.  Backward: each expert's
    gradient is the sum of its replica slots' rows, added one slot after
    another in slot order (an expert serves several slots, and every slot
    past the grants serves E - 1)."""

    @staticmethod
    def forward(ctx, w, sx):
        ctx.save_for_backward(sx)
        ctx.n = w.shape[0]
        return w.index_select(0, sx)

    @staticmethod
    def backward(ctx, grad):
        (sx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.n,) + tuple(grad.shape[1:]))
        for j in range(grad.shape[0]):
            out.index_add_(0, sx[j:j + 1], grad[j:j + 1])
        return out, None


def _gather(x: torch.Tensor, disp: Dispatch, n_slots: int) -> torch.Tensor:
    """The dispatch buffer [S, g*cap, d]: each bin's tokens, zeros where a
    bin is not full."""
    d = x.shape[-1]
    k = disp.pos.shape[0] // (x.numel() // d)
    return _Dispatch.apply(x.reshape(-1, d), disp.src, disp.pos, k).view(n_slots, -1, d)


_W = ("w_gate", "w_up", "w_down")


def _ffn(xs, wg, wu, wd):
    return torch.bmm(F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu), wd)


def _expert_mlp(xa: torch.Tensor, w: dict, disp: Dispatch, n_experts: int) -> torch.Tensor:
    """silu(xa W_gate) * (xa W_up) W_down, slot by slot: the E primary slots
    on the experts' own weights, the replica slots on the weights of the
    experts they serve (gathered, the paper's "replicate the small side")."""
    dt = xa.dtype
    y = _ffn(xa[:n_experts], *(w[name].to(dt) for name in _W))
    if disp.slot_expert is None:
        return y
    sx = disp.slot_expert[n_experts:].long()
    wx = [_SlotWeights.apply(w[name], sx).to(dt) for name in _W]
    y_x = _ffn(xa[n_experts:], *wx)
    return torch.cat([y, y_x])


def _combine_rows(y: torch.Tensor, pos: torch.Tensor, choice: torch.Tensor,
                  topw: torch.Tensor) -> torch.Tensor:
    """[g, tg, d]: each token's choices' rows of ``y`` (``pos``; -1 for a
    choice dropped or not in ``y``), weighted and summed."""
    g, tg, k = topw.shape
    d = y.shape[-1]
    w = torch.where(pos >= 0, topw.reshape(-1), 0.0).to(y.dtype)
    return _Combine.apply(y.reshape(-1, d), w, pos, choice, k).view(g, tg, d)


def _combine(y: torch.Tensor, disp: Dispatch, topw: torch.Tensor) -> torch.Tensor:
    """[g, tg, d]: each token's kept choices' outputs, weighted and summed
    (a dropped choice adds 0)."""
    return _combine_rows(y, disp.pos, disp.choice, topw)


def _own_rows(disp: Dispatch, spans: list[tuple[int, int]]) -> tuple:
    """The dispatch restricted to the buffer rows of the slots in
    ``spans`` (each [lo, hi) slots), in that order: (src, choice) of those
    rows, and each choice's row among them (``pos``; -1 where its row is
    another rank's or it was dropped)."""
    g = disp.loads.shape[1]
    rows = disp.src.numel() // disp.loads.numel() * g  # g * cap rows a slot
    src, choice, pos, at = [], [], torch.full_like(disp.pos, -1), 0
    for lo, hi in spans:
        a, b = lo * rows, hi * rows
        src.append(disp.src[a:b])
        choice.append(disp.choice[a:b])
        inside = (disp.pos >= a) & (disp.pos < b)
        pos = torch.where(inside, disp.pos - a + at, pos)
        at += b - a
    return torch.cat(src), torch.cat(choice), pos


def _expert_parallel(w: dict, x: torch.Tensor, topw: torch.Tensor, disp: Dispatch,
                     n_experts: int, tp) -> torch.Tensor:
    """This rank's partial routed output under expert parallelism: the rows
    of its experts' primary slots and of its replica slots (the weights of
    the experts those serve fetched from their owners), weighted by their
    choices' top-k weights and summed a token; zero for the other ranks'
    choices.  ``x`` and ``topw`` come through ``tp.copy``."""
    extra = disp.loads.shape[0] - n_experts
    p0, p1 = tp.expert_block(n_experts)
    x0, x1 = tp.replica_block(extra)
    src, choice, pos = _own_rows(disp, [(p0, p1), (n_experts + x0, n_experts + x1)])
    d, k, dt = x.shape[-1], topw.shape[-1], x.dtype
    xa = _Dispatch.apply(x.reshape(-1, d), src, pos, k).view(p1 - p0 + x1 - x0, -1, d)
    y = _ffn(xa[:p1 - p0], *(w[name].to(dt) for name in _W))
    if disp.slot_expert is not None:
        # every rank takes part in the fetch, also one that computes no replica slot
        sx = disp.slot_expert[n_experts:].long()
        wx = [tp.fetch_slots(w[name], sx, dt)[x0:x1] for name in _W]
        y = torch.cat([y, _ffn(xa[p1 - p0:], *wx)])
    return _combine_rows(y, pos, choice, topw)


def fetch_bytes(cfg: ArchConfig, extra_slots: int, dtype: torch.dtype, tp) -> int:
    """Bytes one layer's replica-slot weight fetch sums over the model
    group in one forward (``TensorParallel.fetch_slots``: [X, d, f] of each
    of the three expert weights in the compute dtype); its backward moves
    as many in the gradients' dtype.  0 where no fetch runs."""
    if tp is None or not extra_slots or tp.expert_block(cfg.n_experts) is None:
        return 0
    return 3 * extra_slots * cfg.d_model * cfg.d_expert * dtype.itemsize


def expert_split(tp, n_experts: int) -> tuple[str | None, tuple[int, int] | None]:
    """How this rank runs the routed experts under ``tp``: ("experts", its
    experts [lo, hi)) where the rules split them on the expert dim (expert
    parallelism), ("width", its columns [lo, hi) of the expert width f)
    where they split f, else (None, None): the whole experts (gathered
    where the rules split them otherwise), as on one rank."""
    if tp is None:
        return None, None
    block = tp.expert_block(n_experts)
    if block is not None:
        return "experts", block
    cols = tp.block(tp.leaf_split["experts/w_gate"][0][-1])
    return ("width", cols) if cols is not None else (None, None)


def _routed(blk: dict, x: torch.Tensor, topw: torch.Tensor, disp: Dispatch, n_experts: int,
            tp, split: tuple) -> torch.Tensor:
    """The routed experts' output [g, tg, d]: under a ``split``
    (``expert_split``) this rank's partial sum, ``x`` and ``topw`` then
    come through ``tp.copy``."""
    w, s = blk["experts"], disp.loads.shape[0]
    mode, cols = split
    if mode == "experts":
        return _expert_parallel(w, x, topw, disp, n_experts, tp)
    if mode == "width":
        w = {name: tp.local(w[name], f"experts/{name}", 1 if name == "w_down" else 2, *cols)
             for name in _W}
    elif tp is not None:
        w = {name: tp.whole(w[name], f"experts/{name}") for name in _W}
    return _combine(_expert_mlp(_gather(x, disp, s), w, disp, n_experts), disp, topw)


def _aux_loss(probs: torch.Tensor, topi: torch.Tensor, e: int, group, dp) -> torch.Tensor:
    """The Switch-style load-balance loss e·Σ_e frac_e·mean(P_e) of the
    batch ``dp`` (``data_parallel_batch``) describes: each expert's share of
    the routed choices times its mean router probability.  Over a
    data-parallel ``group`` of more than one rank the probability sums are
    added over the ranks through ``tensor_parallel._Sum`` before the product, so each
    rank's router gradient is that of the global aux times the world size
    (the launcher's mean divides it back)."""
    g, tg, k = topi.shape
    counts, groups, _ = dp
    frac = counts.float() / (groups * tg * k)
    p = probs.reshape(-1, e)
    mean = _Sum.apply(p.sum(0), group) / (groups * tg) if _spans_ranks(group) else p.mean(0)
    return e * torch.sum(frac * mean)


def moe_ffn(
    blk: dict,
    x: torch.Tensor,  # [B, L, d]
    cfg: ArchConfig,
    capacity_factor: float = 1.25,
    extra_slots: int = 0,
    return_stats: bool = False,
    group=None,
    tp=None,
):
    """Routed experts (+ the shared expert) of one layer; one dispatch group
    per sequence.  Returns (out [B, L, d], aux), and with ``return_stats``
    a third item: ``dropped``, ``drop_rate``, ``slot_loads`` [E +
    extra_slots], ``aux_loss`` and ``slot_expert`` (None without replica
    slots).  ``group``: the data-parallel process group whose global batch
    this batch is a share of (the replica plan and the aux loss are the
    global batch's, as the JAX package's SPMD host mesh computes them:
    ``data_parallel_batch``); None, or a group of one rank, takes this
    batch alone.  ``tp``: this rank's part of a model split over "model"
    (the output whole on every rank of the model group; where ``tp.seq``,
    ``x`` and the output are this rank's rows of the sequence, and the
    router, the replica plan and the dispatch see the whole of it)."""
    e, k = cfg.n_experts, cfg.top_k
    split = expert_split(tp, e)
    partial = split[0] is not None
    shared, shared_split = local_mlp(blk["shared"], tp, "shared") if cfg.n_shared else (None, False)
    # one copy (or sequence gather) for every partial use of the tokens
    if tp is not None and tp.seq:
        xc = tp.enter(x, partial or shared_split)
        x = tp.alike(xc) if partial or shared_split else xc
    else:
        xc = tp.copy(x) if partial or shared_split else x
    g, tg, _ = x.shape
    s = e + extra_slots
    cap = max(8, int(math.ceil(tg * k * capacity_factor / s)))
    whole = (lambda name: blk[name]) if tp is None else (lambda name: tp.whole(blk[name], name))
    probs, topw, topi = route({"router": whole("router")}, x, k)
    dp = data_parallel_batch(topi, e, group)
    disp = dispatch(topi, e, cap, extra_slots, dp)
    out = _routed(blk, xc if partial else x, tp.copy(topw) if partial else topw, disp, e, tp,
                  split)
    # a partial sum joins the group's (reduce, or reduce-scatter to this
    # rank's rows); a term every rank computes alike is kept as it is, or
    # on this rank's rows
    summed = (lambda z: z) if tp is None else (lambda z: tp.leave(z, True))
    mine = (lambda z: z) if tp is None else (lambda z: tp.leave(z, False))
    if cfg.n_shared:
        gate = torch.sigmoid((x @ whole("shared_gate").to(x.dtype)).float()).to(x.dtype)
        b_down = shared.pop("b_down", None) if shared_split else None
        y = mlp(shared, xc if shared_split else x, cfg.act)
        if partial and shared_split:  # one reduce for both; the gate's gradient summed
            out = summed(out + tp.copy(gate) * y)
        else:
            out = ((summed(out) if partial else mine(out))
                   + (mine(gate) * summed(y) if shared_split else mine(gate * y)))
        if b_down is not None:
            out = out + mine(gate) * row_leaves(tp, b_down).to(x.dtype)
    else:
        out = summed(out) if partial else mine(out)

    aux = _aux_loss(probs, topi, e, group, dp)  # load-balance auxiliary loss (Switch-style)
    if not return_stats:
        return out, aux
    dropped = g * tg * k - (disp.pos >= 0).sum()
    return out, aux, {"dropped": dropped, "drop_rate": dropped / (g * tg * k),
                      "slot_loads": disp.loads.sum(1), "aux_loss": aux,
                      "slot_expert": disp.slot_expert}


# ------------------------------------------------------------------ the model
def _block_apply(cfg: ArchConfig, cap_factor: float, extra_slots: int, group, tp, blk: dict,
                 x: torch.Tensor, is_global: bool):
    h = norm(cfg, blk["ln1"], x, tp)
    x = x + attention(blk["attn"], attn_config(cfg), h, is_global, tp)
    h = norm(cfg, blk["ln2"], x, tp)
    y, aux = moe_ffn(blk, h, cfg, cap_factor, extra_slots, group=group, tp=tp)
    return x + y, aux


def forward_hidden(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    prefix_embeds: torch.Tensor | None = None,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    capacity_factor: float = 1.25,
    extra_slots: int = 0,
    group=None,
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final-norm hidden [B, L*, d], the layers' mean aux loss);
    ``remat``: recompute each block in the backward; ``group``, ``tp``: as
    ``moe_ffn``'s (the sequence split between blocks where its length
    divides the model axis, as ``transformer.forward_hidden`` splits it)."""
    x, tp = stream_in(params, tokens, prefix_embeds, dtype, tp)
    auxs = []
    for blk, is_global in zip(params["blocks"], _layer_flags(cfg)):
        args = (cfg, capacity_factor, extra_slots, group, tp, blk, x, is_global)
        x, aux = remat_block(_block_apply, *args) if remat else _block_apply(*args)
        auxs.append(aux)
    return stream_out(cfg, params, x, tp), torch.stack(auxs).mean()


def loss_fn(
    cfg: ArchConfig,
    params: dict,
    batch: dict,
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    loss_chunk: int = 512,
    capacity_factor: float = 1.25,
    extra_slots: int = 0,
    aux_coef: float = 0.01,
    group=None,
    tp=None,
) -> torch.Tensor:
    """Next-token cross entropy plus ``aux_coef`` times the mean aux loss;
    differentiable, each block rematerialised in the backward under
    ``remat``.  ``group``: as ``moe_ffn``'s (the launcher's at a world
    above one); ``tp``: the readout on this rank's vocab block, as the
    dense family's."""
    tokens = batch["tokens"]
    h, aux = forward_hidden(cfg, params, tokens, batch.get("prefix_embeds"), dtype=dtype,
                            remat=remat, capacity_factor=capacity_factor,
                            extra_slots=extra_slots, group=group, tp=tp)
    if tp is None:
        ce = chunked_cross_entropy(h[:, :-1, :], logits_table(cfg, params), tokens[:, 1:],
                                   chunk=loss_chunk)
    else:
        table, split = split_table(cfg, params, h.dtype, tp)
        ce = chunked_cross_entropy(h[:, :-1, :], table, tokens[:, 1:], chunk=loss_chunk,
                                   tp=tp if split else None)
    return ce + aux_coef * aux


# ------------------------------------------------------------------- serving
def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [B, 1]
    pos: int,  # tokens already in cache
    dtype: torch.dtype = torch.bfloat16,
    capacity_factor: float = 2.0,
    extra_slots: int = 0,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One autoregressive step; returns (logits [B, V] fp32, cache), the
    cache updated in place at ``pos``.  Each sequence is its own dispatch
    group of one token.  Under ``tp`` the cache holds this rank's KV heads
    (``transformer.init_kv_cache(tp=)``) and the logits are whole on every
    rank."""
    x = embed(params["embed"], tokens, dtype, tp)
    acfg = attn_config(cfg)
    for i, (blk, is_global) in enumerate(zip(params["blocks"], _layer_flags(cfg))):
        h = apply_norm(cfg.norm, blk["ln1"], x)
        x = x + attention_decode(blk["attn"], acfg, h, cache["k"][i], cache["v"][i], int(pos),
                                 is_global, tp)
        h = apply_norm(cfg.norm, blk["ln2"], x)
        y, _ = moe_ffn(blk, h, cfg, capacity_factor, extra_slots, tp=tp)
        x = x + y
    return _readout(cfg, params, x, tp), cache


def prefill(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, L]
    cache: dict,
    dtype: torch.dtype = torch.bfloat16,
    capacity_factor: float = 2.0,
    extra_slots: int = 0,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """The parallel prefill (``transformer.prefill``: K6 on the card) with
    each layer's routed experts, one dispatch group a prompt, at the decode
    step's capacity factor.  Returns (last-position logits, cache)."""
    return prefill_with(cfg, params, tokens, cache, dtype, tp, lambda blk, h, tp: moe_ffn(
        blk, h, cfg, capacity_factor, extra_slots, tp=tp)[0])
