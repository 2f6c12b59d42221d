"""Sharding rules: params / optimizer state / batches / caches -> one mesh
axis (or a tuple of axes, or ``None``) per dim; the port of
``repro.launch.sharding``.

Policy (the JAX package's): tensor parallelism over "model" (attention
heads, MLP columns, expert dim, vocab), data parallelism over ("pod",
"data"), ZeRO-1 for the optimizer moments (large replicated leaves get their
biggest divisible dim sharded over "data"), and FSDP over "data" for leaves
of at least ``FSDP_THRESHOLD`` elements.  Rules match on parameter-path
suffixes with a size-aware generic fallback.

The JAX package stacks its blocks, so its rules see each block leaf as
[L, ...] and apply their size thresholds (``FSDP_THRESHOLD``, the fallback's
``1 << 22``, ZeRO-1's ``1 << 20``) to the stacked leaf.  The port keeps a
list of per-layer leaves, L times smaller: measured on them, the thresholds
would give other specs.  So a layer's leaf (``blocks/<i>/...``) is given the
spec of the stacked leaf ``blocks/...`` of shape [L, *leaf.shape], with the
layer dim dropped; the JAX rules never shard that dim of a parameter.
ZeRO-1 would shard it for a moment whose layer count were its largest dim
divisible by "data"; no config has one, and ``opt_specs`` raises there.  Every
other leaf (the embedding, the head, the outer norms, zamba2's unstacked
``shared_attn``) takes the rule as it is.  Caches are stacked [L, B, ...] in
both packages and take the rules as they are.

``placements(mesh, spec)`` turns a spec into ``Shard`` / ``Replicate`` for
each dim of a mesh; ``device_bytes`` reckons what one device holds under a
spec tree from the leaves' shapes alone.  ``shard_tree`` keeps this rank's
slice of every leaf of a tree by its spec, and ``gather_tree`` puts the
whole leaves back together (each an ``all_reduce`` of the slices, placed
in zeros, over the group of the axes that split it: a sum in which one
term is not zero, so exact).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

# path-suffix -> which logical dim (counted from the END, ignoring the
# stacked layer dim) to shard over "model"
_COL = -1  # output/column-parallel (shard last dim)
_ROW = -2  # input/row-parallel (shard second-to-last dim)
_SUFFIX_RULES: list[tuple[str, int]] = [
    ("embed/table", 0),          # vocab-sharded embedding
    ("lm_head/w", _COL),         # [d, V] -> shard vocab
    ("attn/wq/..pad", _COL),
    ("wq", _COL), ("wk", _COL), ("wv", _COL), ("wo", _ROW),
    ("w_gate", _COL), ("w_up", _COL), ("w_down", _ROW),
    ("Wr", _COL), ("Wk", _COL), ("Wv", _ROW), ("Wg", _COL), ("Wo", _ROW),
    ("in_proj", _COL), ("out_proj", _ROW),
]
_EXPERT_RULES = ("experts/w_gate", "experts/w_up", "experts/w_down")

# leaves >= this many elements (stacked) are also FSDP-sharded over "data"
FSDP_THRESHOLD = 1 << 24

Spec = tuple  # one entry a dim: an axis name, a tuple of axis names, or None


def _add_fsdp(dims: list, shape: tuple[int, ...], data_size: int, base: int) -> None:
    if data_size <= 1 or math.prod(shape) < FSDP_THRESHOLD:
        return
    order = sorted(range(base, len(shape)), key=lambda i: -shape[i])
    for i in order:
        if dims[i] is None and shape[i] % data_size == 0:
            dims[i] = "data"
            return


def _spec_for(path: str, shape: tuple[int, ...], model_size: int, stacked: bool,
              data_size: int = 1) -> Spec:
    """The JAX package's rule for one leaf, as a tuple of ``len(shape)``."""
    ndim = len(shape)
    dims: list[Any] = [None] * ndim
    base = 1 if stacked else 0  # skip the scanned layer axis

    for suffix in _EXPERT_RULES:
        if path.endswith(suffix):
            # [L, E, d, f] -> expert parallelism over "model"
            if shape[base] % model_size == 0:
                dims[base] = "model"
                _add_fsdp(dims, shape, data_size, base)
                return tuple(dims)

    for suffix, rule in _SUFFIX_RULES:
        if path.endswith(suffix):
            idx = rule if rule < 0 else base + rule
            if ndim >= (2 if not stacked else 3) or (rule == 0 and ndim >= 2):
                if shape[idx] % model_size == 0:
                    dims[idx] = "model"
                    _add_fsdp(dims, shape, data_size, base)
                    return tuple(dims)
            break

    # generic fallback: big leaves shard their largest divisible dim
    if math.prod(shape) >= 1 << 22:
        order = sorted(range(base, ndim), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % model_size == 0:
                dims[i] = "model"
                _add_fsdp(dims, shape, data_size, base)
                return tuple(dims)
    dims = [None] * ndim
    _add_fsdp(dims, shape, data_size, base)
    return tuple(dims)


def _walk(fn, tree: Any, *others: Any, path: tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf, *other leaves)``;
    dicts and lists, ``None`` an empty subtree.  ``others`` share tree's
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(o[k] for o in others), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, *(o[i] for o in others), path=path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree, *others)


def _stacked(path: tuple, shape: tuple[int, ...], n_layers: int) -> tuple[str, tuple, bool]:
    """The JAX package's view of a leaf: (path string, shape, stacked)."""
    if path[0] == "blocks":
        return "/".join(("blocks",) + path[2:]), (n_layers, *shape), True
    return "/".join(path), shape, False


def param_specs(params: Any, model_size: int, data_size: int = 1) -> Any:
    """A spec a leaf for a params tree (tensors, or anything with a
    ``shape``); ``data_size`` > 1 turns on FSDP of large leaves over
    "data"."""
    n_layers = len(params.get("blocks") or ())

    def spec(path, leaf):
        p, shape, stacked = _stacked(path, tuple(leaf.shape), n_layers)
        out = _spec_for(p, shape, model_size, stacked, data_size)
        return out[1:] if stacked else out

    return _walk(spec, params)


def opt_specs(params_spec: Any, params: Any, data_size: int) -> dict:
    """Optimizer-state specs: the moments follow the params; ZeRO-1 also
    shards big *replicated* moments over "data" (judged on the stacked
    leaf, its layer dim dropped).  Where the JAX rule would pick the
    stacked leaf's layer dim, which a per-layer leaf does not have, this
    raises instead of leaving the moment replicated."""
    n_layers = len(params.get("blocks") or ())

    def mom(path, leaf, spec):
        _, shape, stacked = _stacked(path, tuple(leaf.shape), n_layers)
        full = ((None,) + spec) if stacked else spec
        if all(s is None for s in full) and math.prod(shape) >= (1 << 20):
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[i] % data_size == 0:
                    if stacked and i == 0:
                        raise ValueError(
                            f"opt_specs: ZeRO-1 shards {'/'.join(path)}'s stacked leaf "
                            f"{shape} on its layer dim over 'data' ({data_size}); a "
                            "per-layer leaf has no such dim")
                    full = tuple("data" if j == i else None for j in range(len(shape)))
                    break
        return full[1:] if stacked else full

    m = _walk(mom, params, params_spec)
    return {"m": m, "v": _walk(lambda _, s: s, m), "step": ()}


def _over(dp: tuple[str, ...]):
    """The data axes as one spec entry: a name alone, as ``PartitionSpec``
    writes a one-axis tuple, else the tuple."""
    return dp[0] if len(dp) == 1 else tuple(dp)


def batch_specs(batch: dict, dp: tuple[str, ...]) -> dict:
    """Batch dim over the data axes; everything else replicated."""
    def spec(_, leaf):
        shape = tuple(leaf.shape)
        return tuple(_over(dp) if d == 0 and shape[0] > 1 else None for d in range(len(shape)))

    return _walk(spec, batch)


def cache_specs(cache: Any, dp: tuple[str, ...], model_size: int) -> Any:
    """Decode caches: batch dim over data axes; within each leaf, shard heads
    (or head_dim / long sequence) over "model"/"data" where divisible.

    Layouts: KV [L, B, Hkv, S, hd]; rwkv wkv [L, B, H, hd, hd];
    mamba ssm [L, B, H, p, s]; conv [L, B, K, di]; x_prev [L, B, d]."""

    def spec(_, leaf) -> Spec:
        shape = tuple(leaf.shape)
        dims: list[Any] = [None] * len(shape)
        if len(shape) >= 2 and shape[1] > 1:
            dims[1] = _over(dp)  # batch
        if len(shape) == 5:
            _, b, h, s_or_p, last = shape
            if h % model_size == 0:
                dims[2] = "model"
            elif last % model_size == 0:
                dims[4] = "model"
            if b == 1 and len(dp) == 1 and s_or_p % 16 == 0 and s_or_p >= 4096:
                dims[3] = _over(dp)  # long-context: shard the KV sequence over data
        elif len(shape) in (3, 4):
            if shape[-1] % model_size == 0:
                dims[-1] = "model"
        return tuple(dims)

    return _walk(spec, cache)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Spec) -> tuple:
    """``Shard(d)`` for each mesh dim that shards tensor dim d under
    ``spec``, ``Replicate()`` for the others, in the order of the mesh's
    ``mesh_dim_names`` (a ``DeviceMesh``'s ``placements`` for
    ``distribute_tensor``)."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if name in _axes(entry)]
        if len(dims) > 1:
            raise ValueError(f"placements: mesh axis {name!r} shards dims {dims} of one spec")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def device_bytes(tree: Any, specs: Any, axis_sizes: dict[str, int]) -> int:
    """Bytes one device holds of ``tree`` (leaves with a ``shape`` and a
    ``dtype``: tensors, fake tensors, shape structs) under ``specs``: each
    dim split over the product of its axes' sizes, rounded up."""
    total = 0

    def add(_, leaf, spec):
        nonlocal total
        n = 1
        for size, entry in zip(tuple(leaf.shape), spec):
            n *= -(-size // math.prod(axis_sizes[a] for a in _axes(entry)))
        total += n * leaf.dtype.itemsize

    _walk(add, tree, specs)
    return total


def spec_leaves(specs: Any) -> list[Spec]:
    """The specs of a params-shaped spec tree in ``jax.tree.leaves`` order
    (dicts by sorted key, lists by index, ``None`` empty), as
    ``train.optimizer.leaves`` lists the tensors."""
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [s for key in sorted(specs) for s in spec_leaves(specs[key])]
    if isinstance(specs, list):
        return [s for sub in specs for s in spec_leaves(sub)]
    return [specs]


def sharded_flags(specs: Any, axis: str = "model") -> list[bool]:
    """Per leaf of a spec tree (``spec_leaves``): does ``axis`` split it?"""
    return [any(axis in _axes(e) for e in spec) for spec in spec_leaves(specs)]


def shard_slices(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under ``spec``: each dim
    that names axes is cut into as many equal parts as those axes have
    ranks, and this rank takes the part of its index along them
    (``mesh.size``, ``mesh.index``: a ``launch.mesh.Mesh``)."""
    out = []
    for size, entry in zip(shape, spec):
        axes = _axes(entry)
        parts = mesh.size(axes) if axes else 1
        if size % parts:
            raise ValueError(f"shard_slices: dim of {size} does not split over {axes} "
                             f"({parts} ranks)")
        n = size // parts
        i = mesh.index(axes) if axes else 0
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` (tensors, ``None`` subtrees) with every leaf cut to this
    rank's block under its spec: a copy where a dim was cut, so the whole
    leaf can be freed; the leaf itself where none was."""
    def cut(_, leaf, spec):
        if not any(_axes(e) for e in spec):
            return leaf
        return leaf[shard_slices(tuple(leaf.shape), spec, mesh)].clone(
            memory_format=torch.contiguous_format)

    return _walk(cut, tree, specs)


def gather_leaf(leaf: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf of which ``leaf`` is this rank's block under ``spec``
    (every rank of the groups that split it must call this too)."""
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        parts, i = mesh.size(axes), mesh.index(axes)
        n = leaf.shape[d]
        shape = list(leaf.shape)
        shape[d] = n * parts
        full = leaf.new_zeros(shape)
        full.narrow(d, i * n, n).copy_(leaf)
        dist.all_reduce(full, group=mesh.group(axes))
        leaf = full
    return leaf


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole leaves of a tree that ``shard_tree`` cut, one leaf at a
    time, on the leaves' device.  A collective: every rank of the mesh
    calls it, in the same order."""
    return _walk(lambda _, leaf, spec: gather_leaf(leaf.detach(), spec, mesh), tree, specs)
