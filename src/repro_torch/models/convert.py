"""Carry the JAX package's parameters into the port.

``params_from_jax(cfg, params)`` takes the parameter tree of
``repro.models.transformer.init_params`` or ``repro.models.rwkv6.init_params``
with numpy (or array-like) leaves, its blocks stacked on axis 0, and returns
the port's parameters: the same nested keys (``ln0``, the nested ``tm`` /
``cm`` / ``ln_x`` dicts and all) with ``blocks`` as a list of per-layer
dicts.  It imports nothing of JAX; a caller hands it
``jax.tree.map(np.asarray, params)``.
Tests use it to run both packages on identical weights, since
``jax.random`` and ``torch.Generator`` draw different numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.mapreduce.executor import _device


def _tree(node, fn):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(cfg: ArchConfig, params: dict, device: torch.device | str = "cuda") -> dict:
    """The port's parameters, float32 on ``device`` as the JAX package
    keeps them, from the JAX package's tree (dense, vlm, audio and ssm
    families)."""
    dev = _device(device)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    out = {key: _tree(node, put) for key, node in params.items() if key != "blocks"}
    out["blocks"] = [
        _tree(params["blocks"], lambda a, i=i: put(np.asarray(a)[i]))
        for i in range(cfg.n_layers)
    ]
    return out
