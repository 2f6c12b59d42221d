"""Tensor parallelism over a mesh's "model" axis for every family: the
counterpart of the JAX package's activation-sharding hooks
(``repro.models.layers.set_activation_sharding`` and ``constrain_*``, which
the JAX launcher sets under ``--mesh prod``).

Where the JAX package states the shardings and lets XLA partition the step,
the port computes on each rank's blocks and places the collectives by hand,
Megatron's way:

  * column-parallel ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` (RWKV-6's
    ``Wr``, ``Wk``, ``Wg``): the input goes through ``copy`` (identity
    forward, ``all_reduce`` of its gradient);
  * row-parallel ``wo``, ``w_down`` (RWKV-6's ``Wo`` and channel-mix
    ``Wv``, Mamba2's ``out_proj``): the partial outputs go through
    ``reduce`` (``all_reduce`` forward, identity backward); a bias such as
    ``b_down`` is added once, after it;
  * a sum that each rank then uses on its own part (Mamba2's gated RMSNorm
    over the whole d_inner, of which a rank holds its heads' channels) goes
    through ``sum``: ``all_reduce`` forward and backward;
  * a vocab-split embedding looks up its own rows (the others masked to 0)
    and ``reduce``s; a vocab-split readout feeds ``layers.
    chunked_cross_entropy``'s vocab-parallel form (a MAX ``all_reduce`` of
    the row max, SUM of the exponent sums and of the gold logit);
  * a leaf whose split is not the one its use site computes on (the rules
    split columns wherever the column count divides, not heads: internvl2-1b's
    ``wk`` at model = 4, RWKV-6's time-mix ``Wv`` split on its input dim,
    Mamba2's ``in_proj`` cut across its segments; an embedding split on d
    where the vocab does not divide) is put together whole (``gather``: an
    ``all_reduce`` of the block placed in zeros) and sliced.

Over the model group go ``all_reduce`` and ``broadcast`` and, for the
stream's sequence, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``:
NCCL (a rank a card) and gloo, on the CPU and with several ranks on one card
(CUDA tensors; torch 2.11 on an H100), take all four, so one code path runs
over each.  K6, K6b, K7 and K7b are custom autograd functions and run
unchanged on each rank's heads: the layers work on local tensors, not on
DTensors.

The MoE family splits its experts as ``_EXPERT_RULES`` place them (expert
parallelism): where the expert count divides the axis, a rank holds
experts [r E/m, (r+1) E/m) and computes only those primary slots' rows of
the dispatch buffer, and the SharesSkew replica slots are spread over the
ranks as ``constrain_moe_dispatch`` splits the JAX package's replica buffer
(``replica_block``).  A replica slot serves an expert chosen at run time,
whose weights usually live on another rank: ``fetch_slots`` shares them
over the group (each owner writes its experts' rows into zeros, one
``all_reduce``), and its backward shares the slots' gradients the same way
before each owner adds them to its experts, one slot at a time in slot
order.  Where the experts do not divide, the rules split each expert's
width f (``w_gate``/``w_up`` columns, ``w_down`` rows) and every rank runs
every slot on its block.  Either way a rank's routed output is partial and
joins one ``reduce`` (``leave``).

The recurrent families split their heads: RWKV-6's time mix runs K7 (K7b
under a gradient) on a rank's heads, its channel mix is Megatron's MLP
(``models.rwkv6``); Mamba2 runs the SSD on a rank's SSM heads and Zamba2's
shared block attends with its attention heads (``models.mamba2``).  Where
the heads do not divide the axis every rank runs every head on whole
leaves, as attention does.

Sequence parallelism: the residual stream's sequence is split over the
model group between blocks, as the JAX launcher's ``P(dp, "model", None)``
splits it (``constrain_activations`` at each block's entry): where the
stream's length S (a prefix joined on) divides the group's size m, rank r
holds rows [r S/m, (r+1) S/m) of the [B, S, d] stream (``over``, which
sets ``seq``); otherwise (decode at L = 1, an odd length) the stream is
whole on every rank, as ``_apply_spec`` leaves a dim that does not divide.
There is no switch: the reference splits whenever the model axis is above
one.  A column-parallel mixer's entry gathers the sequence (``enter``: the
all-gather, its gradient reduce-scattered, Megatron's g in place of
``copy``) and its row-parallel exit reduce-scatters the partial outputs
(``leave``: in place of ``reduce``, the gradient all-gathered); a mixer
whose heads or columns do not split computes the whole sequence alike on
every rank from the gathered stream and keeps its rows.  The norms, the
residual adds and ``b_down`` act on a rank's rows, so their leaves' gradients
are partial and go through ``copy`` (``row_leaves``); a replicated leaf
that a rank uses on its own heads or columns (RWKV-6's ``mu_*``, ``w0``,
``u``, ``ln_x``; Mamba2's ``conv_w``, ``A_log``, ``D``, ``dt_bias``,
``norm_scale``) is taken through ``local``, whose ``copy`` sums its
gradient over the group, so every replicated leaf stays bit-identical
across a model group.  The final norm's rows are gathered for the readout
(``enter(x, False)``), which stays as it was.

``leaf_split`` keys a leaf by its path inside its block (``attn/wq``,
``mlp/w_down``, ``experts/w_gate``, MoE's shared expert ``shared/w_up``,
RWKV-6's ``tm/Wv`` and ``cm/Wv``, which the rules split on different dims,
Mamba2's ``in_proj``); Zamba2's shared block has a transformer block's
paths.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """The sum over the group forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Sum(torch.autograd.Function):
    """The sum over the group forward, and the gradient summed over the
    group: for a sum whose result each rank uses on its own part, so that
    each rank's gradient of it is partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """The whole tensor from each rank's block along ``dim`` (placed in
    zeros, summed over the group: exact); the gradient's own block back.
    For a whole tensor that every rank of the group computes the same
    with."""

    @staticmethod
    def forward(ctx, x, dim, index, parts, group):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= parts
        out = x.new_zeros(shape)
        out.narrow(dim, index * ctx.n, ctx.n).copy_(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        block = grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n)
        return block.contiguous(), None, None, None, None


def _all_gather_rows(x: torch.Tensor, tp) -> torch.Tensor:
    """The group's blocks [B, n, ...] of a tensor split on dim 1, in rank
    order: [B, m n, ...], as ``torch.cat`` along dim 1 gives them."""
    n, m = x.shape[1], tp.size
    # the collective works on dim 0: each rank's block is one contiguous [B, n, ...]
    rest = tuple(x.shape[2:])
    out = x.new_empty((m * x.shape[0], n) + rest)
    dist.all_gather_into_tensor(out, x.contiguous(), group=tp.group)
    return out.view((m, x.shape[0], n) + rest).movedim(0, 1).reshape((x.shape[0], m * n) + rest)


def _reduce_scatter_rows(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum over the group of [B, m n, ...]; this rank's rows [B, n, ...]."""
    m = tp.size
    n = x.shape[1] // m
    rest = tuple(x.shape[2:])
    blocks = x.reshape((x.shape[0], m, n) + rest).movedim(1, 0).reshape((m * x.shape[0], n) + rest)
    out = x.new_empty((x.shape[0], n) + rest)
    dist.reduce_scatter_tensor(out, blocks, group=tp.group)
    return out


def _own_rows(x: torch.Tensor, tp) -> torch.Tensor:
    n = x.shape[1] // tp.size
    return x.narrow(1, tp.rank * n, n).contiguous()


class _SeqGather(torch.autograd.Function):
    """The whole sequence from the ranks' rows (all-gather); the gradient,
    a partial sum on each rank, reduce-scattered: for a mixer that computes
    this rank's part (its heads, its columns) from the whole sequence."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather_rows(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_rows(grad, ctx.tp), None


class _SeqScatter(torch.autograd.Function):
    """The sum over the group of a partial [B, S, ...], this rank's rows
    (reduce-scatter); the gradient of the rows all-gathered."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_rows(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_rows(grad, ctx.tp), None


class _SeqWhole(torch.autograd.Function):
    """The whole sequence from the ranks' rows (all-gather), for work that
    every rank of the group does alike; the gradient, the same on every
    rank, its own rows back."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather_rows(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _own_rows(grad, ctx.tp), None


class _SeqSplit(torch.autograd.Function):
    """This rank's rows of a whole [B, S, ...] that every rank computes
    alike; the gradient of the rows all-gathered (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _own_rows(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_rows(grad, ctx.tp), None


class _Alike(torch.autograd.Function):
    """Identity forward on a sequence gathered for partial work
    (``_SeqGather``), for a use that every rank makes alike (MoE's router):
    the gradient, the same on every rank, kept on this rank's rows only (0
    elsewhere), so the gather's reduce-scatter counts it once."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        n = grad.shape[1] // tp.size
        out = torch.zeros_like(grad, memory_format=torch.contiguous_format)
        out.narrow(1, tp.rank * n, n).copy_(grad.narrow(1, tp.rank * n, n))
        return out, None


def row_leaves(tp, tree):
    """``tree`` (a norm's leaves, a leaf, or None) for work on this rank's
    rows of the stream: each tensor through ``copy`` where the stream is
    split (a rank's gradient is its rows' part), as it is otherwise."""
    if tp is None or not tp.seq or tree is None:
        return tree
    if isinstance(tree, dict):
        return {key: row_leaves(tp, sub) for key, sub in tree.items()}
    return tp.copy(tree)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's part of a model split over ``mesh``'s "model" axis.

    ``specs`` is the parameter tree's specs (``launch.sharding.
    param_specs``), ``leaf_split`` maps a leaf's path inside its block
    (``attn/wq``, ``mlp/w_down``, ``tm/Wv``, ...; ``table`` for the
    embedding, ``lm_head`` for the untied head) to (its whole shape, the
    dim "model" splits or None).  ``seq``: the stream's sequence is split
    over the group (``over``)."""

    mesh: object  # launch.mesh.Mesh
    specs: dict
    leaf_split: dict
    seq: bool = False

    @property
    def size(self) -> int:
        return self.mesh.size("model")

    @property
    def rank(self) -> int:
        return self.mesh.index("model")

    @property
    def group(self) -> dist.ProcessGroup:
        return self.mesh.group("model")

    def over(self, length: int) -> "TensorParallel":
        """This split for a stream of ``length`` positions: its sequence
        split over the group (``seq``) where ``length`` divides the group's
        size, whole otherwise."""
        seq = self.size > 1 and length % self.size == 0
        return self if seq == self.seq else dataclasses.replace(self, seq=seq)

    def enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """A mixer's input from the stream as this rank holds it: where the
        sequence is split, gathered whole (``split``: for this rank's part,
        the gradient reduce-scattered; else for work every rank does alike);
        else ``x``, through ``copy`` where ``split``."""
        if self.seq:
            return (_SeqGather if split else _SeqWhole).apply(x, self)
        return self.copy(x) if split else x

    def leave(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """A mixer's output as the stream takes it: ``split``, this rank's
        partial sum, summed over the group (reduce-scattered to this rank's
        rows where the sequence is split); else a whole output every rank
        computed alike (this rank's rows of it where the sequence is
        split)."""
        if self.seq:
            return (_SeqScatter if split else _SeqSplit).apply(y, self)
        return self.reduce(y) if split else y

    def alike(self, x: torch.Tensor) -> torch.Tensor:
        """A sequence gathered by ``enter(x, True)``, for a use every rank
        makes alike (``_Alike``; the sequence is split)."""
        return _Alike.apply(x, self)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim % x.dim(), self.rank, self.size, self.group)

    def split_dim(self, name: str | None) -> int | None:
        return self.leaf_split.get(name, (None, None))[1] if name else None

    def whole(self, w: torch.Tensor, name: str | None) -> torch.Tensor:
        """Leaf ``name`` whole, for work every rank of the group does alike."""
        d = self.split_dim(name)
        return w if d is None else self.gather(w, d)

    def local(self, w: torch.Tensor, name: str | None, dim: int, lo: int,
              hi: int) -> torch.Tensor:
        """Entries [lo, hi) along ``dim`` of leaf ``name``, for work that
        this rank does on its own part (its heads, its MLP columns).  This
        rank's block where it is just that; else the whole leaf (gathered if
        split), through ``copy`` so that its gradient sums every rank's
        part, then sliced."""
        d = self.split_dim(name)
        if d == dim and w.shape[dim] * self.rank == lo and w.shape[dim] == hi - lo:
            return w
        full = self.copy(w if d is None else self.gather(w, d))
        return full.narrow(dim, lo, hi - lo)

    def block(self, total: int) -> tuple[int, int] | None:
        """This rank's equal share [lo, hi) of ``total`` entries, or None
        where they do not split."""
        if total % self.size:
            return None
        n = total // self.size
        return self.rank * n, (self.rank + 1) * n

    def expert_block(self, n_experts: int) -> tuple[int, int] | None:
        """This rank's experts [lo, hi) where the rules split the experts
        on their expert dim (``_EXPERT_RULES``), else None."""
        return self.block(n_experts) if self.split_dim("experts/w_gate") == 0 else None

    def replica_block(self, extra_slots: int) -> tuple[int, int]:
        """This rank's replica slots [lo, hi) (0 being slot E), as
        ``constrain_moe_dispatch`` splits the replica buffer's slot dim
        over "model": an equal share where ``extra_slots`` divides the axis;
        where it does not, that dim stays whole and the group's first rank
        computes every replica slot (the others none)."""
        return self.block(extra_slots) or ((0, extra_slots) if self.rank == 0 else (0, 0))

    def slot_ranks(self, n_experts: int, extra_slots: int) -> list[int] | None:
        """The rank that computes each of the E + X slots where the experts
        split (``expert_block``), else None: every rank then runs every
        slot on its block of the expert width."""
        if self.expert_block(n_experts) is None:
            return None
        per = n_experts // self.size
        x = extra_slots // self.size if extra_slots % self.size == 0 else 0
        return ([e // per for e in range(n_experts)]
                + [j // x if x else 0 for j in range(extra_slots)])

    def fetch_slots(self, w: torch.Tensor, slot_expert: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
        """The weights of the experts ``slot_expert`` [X] in ``dtype`` from
        this rank's expert block ``w`` and the others' (``_FetchSlots``);
        every rank of the group calls it."""
        lo = self.expert_block(w.shape[0] * self.size)[0]
        return _FetchSlots.apply(w, slot_expert, lo, dtype, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group (no gradient)."""
        x = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the group's first rank holds it, on every rank (in place)."""
        dist.broadcast(x, src=dist.get_global_rank(self.group, 0), group=self.group)
        return x


class _FetchSlots(torch.autograd.Function):
    """This rank's experts ``w`` [n, ...] (experts [lo, lo + n)) -> the
    weights [X, ...] of the experts ``sx`` [X] that the replica slots
    serve, in ``dtype``, on every rank: each owner writes its experts' rows
    into zeros and one ``all_reduce`` sums them (one term is not zero:
    exact).  Backward: the slots' gradients summed the same way (each slot
    has one rank that computes it), then each owner adds them to its
    experts in fp32, one slot after another in slot order, so two steps
    from one state agree bit for bit."""

    @staticmethod
    def forward(ctx, w, sx, lo, dtype, group):
        n = w.shape[0]
        mine = (sx >= lo) & (sx < lo + n)
        row = torch.where(mine, sx - lo, n)  # n: a row past this rank's experts
        out = w.index_select(0, row.clamp(max=n - 1)).to(dtype)
        out.mul_(mine.view((-1,) + (1,) * (w.dim() - 1)).to(dtype))
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(row)
        ctx.n, ctx.dtype, ctx.group = n, w.dtype, group
        return out

    @staticmethod
    def backward(ctx, grad):
        (row,) = ctx.saved_tensors
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        out = grad.new_zeros((ctx.n + 1,) + tuple(grad.shape[1:]), dtype=ctx.dtype)
        for j in range(grad.shape[0]):
            out.index_add_(0, row[j:j + 1], grad[j:j + 1].to(ctx.dtype))
        return out[:ctx.n], None, None, None, None


def parts(tree: dict, prefix: str, tp: TensorParallel | None, split: bool):
    """``part(path, dim, lo, hi, dtype=None)``: the leaf at ``path``
    (``ln_x/scale``) of a block's subtree ``tree``, whose paths in
    ``leaf_split`` start with ``prefix``, cast to ``dtype`` (before any
    gather: fewer bytes), as this rank works with it.  ``split``: its
    entries [lo, hi) along ``dim``, its gradient summed over the group
    (``tp.local``); else the whole leaf (gathered where the rules split
    it); ``tp`` None: the leaf."""

    def part(path, dim, lo, hi, dtype=None):
        leaf = tree
        for key in path.split("/"):
            leaf = leaf[key]
        leaf = leaf if dtype is None else leaf.to(dtype)
        if tp is None:
            return leaf
        if split:
            return tp.local(leaf, prefix + path, dim, lo, hi)
        return tp.whole(leaf, prefix + path)

    return part


def _split(leaf, spec) -> tuple:
    dims = [d for d, e in enumerate(spec) if e == "model"]
    return tuple(leaf.shape), dims[0] if dims else None


def leaf_split(specs: dict, params: dict) -> dict:
    """(whole shape, split dim) by a leaf's path inside its block
    (``attn/wq``, ``experts/w_gate``, ``tm/Wv``, ``in_proj``, ...), from the
    first block's leaves and Zamba2's shared block (every block of a config
    has the same specs), and ``table`` / ``lm_head`` for the embedding and
    the untied head."""
    out = {}

    def visit(tree, spec, prefix=""):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                visit(sub, spec[key], f"{prefix}{key}/")
            elif sub is not None:
                out[prefix + key] = _split(sub, spec[key])

    if params.get("blocks"):
        visit(params["blocks"][0], specs["blocks"][0])
    if "shared_attn" in params:
        visit(params["shared_attn"], specs["shared_attn"])
    out["table"] = _split(params["embed"]["table"], specs["embed"]["table"])
    if "lm_head" in params:
        out["lm_head"] = _split(params["lm_head"]["w"], specs["lm_head"]["w"])
    return out
