"""AdamW with warmup+cosine schedule and global-norm clipping: the
counterpart of ``repro.train.optimizer``, its formula as written there.

Params stay fp32 (the master copy); the models cast to the compute dtype
on entry, so mixed precision falls out as in the JAX package.  m and v are
fp32 and shaped like the params; ``step`` is an int32 scalar on the
params' device, and the schedule, the bias corrections and the clip scale
are device scalars, so an update never waits for the host.  Written out by
hand rather than ``torch.optim.AdamW``, which rounds otherwise and decays
every tensor: here decay is decoupled and touches ``ndim >= 2`` leaves
only.  Where the JAX package returns new arrays, ``adamw_update`` updates
params, m and v in place under ``torch.no_grad()`` (``torch._foreach_*``),
which spares a second copy of each.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch.sharding import sharded_flags


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree: Any) -> list:
    """The tensors of a params-shaped tree in ``jax.tree.leaves`` order:
    dicts by sorted key, lists by index, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def map_tree(fn, tree: Any) -> Any:
    """``tree`` with every tensor ``t`` replaced by ``fn(t)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map_tree(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, sub) for sub in tree)
    return fn(tree)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; fp32 on the step's device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init_opt_state(params: Any) -> dict:
    """Zero fp32 m and v shaped like ``params``, and step 0 on their device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
    device = leaves(params)[0].device
    return {
        "m": map_tree(zeros, params),
        "v": map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any, tp=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32.  Under ``tp`` (a
    ``models.tensor_parallel.TensorParallel``) the leaves split over "model"
    add their squares over the model group and every other leaf, the same
    on each rank of it, counts once: the whole model's norm on every rank."""
    parts = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if tp is None:
        return torch.sqrt(torch.stack(parts).sum())
    flags = sharded_flags(tp.specs)
    if len(flags) != len(parts):
        raise ValueError(f"global_norm: {len(parts)} leaves for {len(flags)} specs")
    zero = parts[0].new_zeros(())
    split = torch.stack([p for p, f in zip(parts, flags) if f] + [zero]).sum()
    dist.all_reduce(split, group=tp.group)
    return torch.sqrt(split + torch.stack([p for p, f in zip(parts, flags) if not f] + [zero]).sum())


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled by min(1, max_norm / (norm + 1e-9)) (new tensors),
    and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return map_tree(lambda g: g * scale, grads), norm


_GROUP = 8  # leaves updated together: the update's temporaries stay a few leaves large


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: OptConfig,
                 tp=None) -> tuple[Any, dict, dict]:
    """One AdamW step: returns (params, state, metrics) with params, m and v
    updated in place (a few leaves at a time, so the temporaries stay
    small) and ``metrics`` = {grad_norm, lr} as device scalars.  ``tp``: the
    model's split over "model", for the clip's ``global_norm``."""
    p_list, g_list = leaves(params), leaves(grads)
    m_list, v_list = leaves(state["m"]), leaves(state["v"])
    if not len(p_list) == len(g_list) == len(m_list) == len(v_list):
        raise ValueError(f"adamw_update: {len(g_list)} gradients for {len(p_list)} params")
    gnorm = global_norm(g_list, tp)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for lo in range(0, len(p_list), _GROUP):
        ps, ms, vs = (x[lo:lo + _GROUP] for x in (p_list, m_list, v_list))
        gs = [g.float() for g in torch._foreach_mul(g_list[lo:lo + _GROUP], clip)]
        torch._foreach_mul_(ms, cfg.b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - cfg.b1))
        torch._foreach_mul_(vs, cfg.b2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, 1 - cfg.b2), gs))
        del gs
        vhat = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, cfg.eps)
        delta = torch._foreach_div(torch._foreach_div(ms, bc1), vhat)
        del vhat
        mats = [i for i, p in enumerate(ps) if p.dim() >= 2]  # decoupled decay on matrices
        if mats:
            torch._foreach_add_([delta[i] for i in mats],
                                torch._foreach_mul([ps[i].float() for i in mats],
                                                   cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(ps, delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm, "lr": lr}
