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

Only ``all_reduce`` and ``broadcast`` go over the model group: the
collectives gloo takes on CUDA tensors, so one code path runs over NCCL (a
rank a card), over gloo on the CPU, and over gloo with several ranks on one
card.  K6, K6b, K7 and K7b are custom autograd functions and run unchanged
on each rank's heads: the layers work on local tensors, not on DTensors.

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
joins one ``reduce``.

The recurrent families split their heads: RWKV-6's time mix runs K7 (K7b
under a gradient) on a rank's heads, its channel mix is Megatron's MLP
(``models.rwkv6``); Mamba2 runs the SSD on a rank's SSM heads and Zamba2's
shared block attends with its attention heads (``models.mamba2``).  Where
the heads do not divide the axis every rank runs every head on whole
leaves, as attention does.

The residual stream stays whole on every rank of a model group (the JAX
launcher's ``P(dp, "model", None)`` also splits its sequence over "model":
sequence parallelism, ROADMAP item 29).  The results are the same; the
activation memory is not.  Norm scales and ``b_down`` act on the whole
stream and stay bit-identical across a model group: each rank computes the
same gradient for them.  A replicated leaf that a rank uses only on its own
part (RWKV-6's ``mu_*``, ``w0``, ``u``, ``ln_x``; Mamba2's ``conv_w``,
``A_log``, ``D``, ``dt_bias``, ``norm_scale``) is taken through ``local``,
whose ``copy`` sums its gradient over the group, so it too stays
bit-identical.

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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's part of a model split over ``mesh``'s "model" axis.

    ``specs`` is the parameter tree's specs (``launch.sharding.
    param_specs``), ``leaf_split`` maps a leaf's path inside its block
    (``attn/wq``, ``mlp/w_down``, ``tm/Wv``, ...; ``table`` for the
    embedding, ``lm_head`` for the untied head) to (its whole shape, the
    dim "model" splits or None)."""

    mesh: object  # launch.mesh.Mesh
    specs: dict
    leaf_split: dict

    @property
    def size(self) -> int:
        return self.mesh.size("model")

    @property
    def rank(self) -> int:
        return self.mesh.index("model")

    @property
    def group(self) -> dist.ProcessGroup:
        return self.mesh.group("model")

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
