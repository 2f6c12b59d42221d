"""Gradient compression for the cross-pod all-reduce: the counterpart of
``repro.train.compression``.

int8 quantized all-reduce with error feedback (1-bit-Adam-family trick):
each rank quantizes (grad + residual) to the int8 grid of a shared absmax
scale, all-reduces the grid values (summed as int32), dequantizes, and keeps
the quantization error as the next step's residual, so the compression
bias telescopes instead of accumulating.

The collectives run over a ``torch.distributed`` process group: the
caller's, the default group when one is initialized, or this process's
one-rank group (``repro_torch.distributed.resolve_group``: NCCL for CUDA
tensors, gloo for the CPU).  Trees are the port's params-shaped dicts and
lists, walked in ``jax.tree.leaves`` order.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed import resolve_group

from .optimizer import leaves, map_tree

_LEVELS = 127.0


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / _LEVELS + 1e-12
    q = torch.clamp(torch.round(g / scale), -_LEVELS, _LEVELS).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(
    grad: torch.Tensor,
    residual: torch.Tensor,
    group: dist.ProcessGroup | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over ``group``.

    Returns (mean gradient over the ranks, new residual).  The scale is
    all-reduced (max) so every rank uses the same grid; the grid values are
    what cross the wire.  fp32 operations in the JAX package's order;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    group = resolve_group(group, grad.device)
    g = grad.to(torch.float32) + residual
    scale = g.abs().max() / _LEVELS + 1e-12
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)  # shared grid
    q = torch.clamp(torch.round(g / scale), -_LEVELS, _LEVELS)
    new_residual = g - q * scale  # error feedback
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return total.to(torch.float32) * scale / group.size(), new_residual


def init_residuals(grads_template: Any) -> Any:
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_template)


def compressed_tree_psum(
    grads: Any, residuals: Any, group: dist.ProcessGroup | None = None,
) -> tuple[Any, Any]:
    """``compressed_psum`` leaf by leaf, in ``leaves`` order; returns (mean
    grads, residuals) as trees shaped like ``grads``."""
    out = [compressed_psum(g, r, group) for g, r in zip(leaves(grads), leaves(residuals))]
    return (_unflatten(grads, iter([o[0] for o in out])),
            _unflatten(grads, iter([o[1] for o in out])))


def _unflatten(tree: Any, values) -> Any:
    """``tree`` with its leaves replaced, in ``leaves`` order, by
    ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {key: _unflatten(tree[key], values) for key in sorted(tree)}
        return {key: new[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(sub, values) for sub in tree)
    return next(values)
