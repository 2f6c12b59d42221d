"""Train-step factory: the counterpart of ``repro.train.train_step``.

``make_train_step(model, opt_cfg)`` returns a (params, opt_state, batch)
-> (params, opt_state, metrics) function, the JAX signature: one forward
and backward of ``model.loss_fn`` (autograd; on the card K6 and its
backward kernel in every full-window layer) and one ``adamw_update``.
Params are fp32 leaves with ``requires_grad``; the step clears their
gradients before the backward and after the update, and updates params,
m and v in place.  ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as
device scalars, so a step never waits for the card.  ``loss_kwargs``
(dtype, remat, loss_chunk; for the moe family also capacity_factor,
extra_slots and aux_coef) thread through to the model's loss.
``reduce_grads``, when given, takes the gradient tree before the update and
returns the one to apply: the launcher's data-parallel mean over the ranks
of its data group (``repro_torch.launch.train``).  A model split over
"model" (``model.tp``) needs no reduction over that axis: each rank holds
its blocks' whole gradient, and the clip's norm adds the split leaves'
squares over the model group (``optimizer.global_norm``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.zoo import ModelApi

from .optimizer import OptConfig, adamw_update, init_opt_state, leaves, map_tree


def make_train_step(
    model: ModelApi,
    opt_cfg: OptConfig,
    loss_kwargs: dict | None = None,
    reduce_grads: Callable[[Any], Any] | None = None,
) -> Callable:
    loss_kwargs = dict(loss_kwargs or {})

    def train_step(params: Any, opt_state: dict, batch: dict):
        for p in leaves(params):
            p.grad = None
        with torch.enable_grad():
            loss = model.loss_fn(params, batch, **loss_kwargs)
            loss.backward()
        grads = map_tree(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params)
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg, model.tp)
        del grads
        for p in leaves(params):
            p.grad = None
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def init_train_state(model: ModelApi, seed: int) -> tuple[Any, dict]:
    """fp32 params from ``seed`` (``model.init_params``) with
    ``requires_grad``, and a zero optimizer state."""
    params = model.init_params(seed)
    for p in leaves(params):
        p.requires_grad_(True)
    return params, init_opt_state(params)
