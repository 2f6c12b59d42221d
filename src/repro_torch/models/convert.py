"""Carry the JAX package's parameters into the port.

``params_from_jax(cfg, params)`` takes the parameter tree of
``repro.models.transformer.init_params``, ``repro.models.moe.init_params``,
``repro.models.rwkv6.init_params`` or ``repro.models.mamba2.init_params``
with numpy (or array-like) leaves, its blocks stacked on axis 0, and returns
the port's parameters: the same nested keys (``ln0``, the nested ``tm`` /
``cm`` / ``ln_x`` dicts, MoE's ``router``, ``experts`` [L, E, d, f] sliced
to [E, d, f] a layer, ``shared`` and ``shared_gate``, the hybrid's
``shared_attn`` block, one block as it is, and all) with ``blocks`` as a
list of per-layer dicts.  It imports nothing of JAX; a caller hands it
``jax.tree.map(np.asarray, params)``.
Tests use it to run both packages on identical weights, since
``jax.random`` and ``torch.Generator`` draw different numbers; with ``tp``
(a ``tensor_parallel.TensorParallel``) each rank keeps its blocks
(``launch.sharding.shard_tree``).

The training state crosses the same way: ``train_state_from_jax`` takes
``{"params", "opt": {"m", "v", "step"}}`` in the JAX layout (blocks
stacked on axis 0), ``train_state_to_jax_layout`` stacks the port's block
lists back as numpy, and ``flat_from_jax_layout`` unstacks a checkpoint's
flat arrays into the port's keys, so a training checkpoint that either
package writes restores in the other (``train.checkpoint.restore_tree``).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import shard_tree
from repro_torch.mapreduce.executor import _device


def _tree(node, fn):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(cfg: ArchConfig, params: dict, device: torch.device | str = "cuda",
                    tp=None) -> dict:
    """The port's parameters, float32 on ``device`` as the JAX package
    keeps them, from the JAX package's tree (dense, vlm, audio, moe, ssm
    and hybrid families); under ``tp`` this rank's blocks of them."""
    dev = _device(device)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    out = {key: _tree(node, put) for key, node in params.items() if key != "blocks"}
    out["blocks"] = [
        _tree(params["blocks"], lambda a, i=i: put(np.asarray(a)[i]))
        for i in range(cfg.n_layers)
    ]
    return out if tp is None else shard_tree(out, tp.specs, tp.mesh)


def train_state_from_jax(cfg: ArchConfig, tree: dict, device: torch.device | str = "cuda") -> dict:
    """The port's training state (fp32 params and m, v; step an int32
    scalar) on ``device`` from the JAX package's ``{"params", "opt": {"m",
    "v", "step"}}`` with numpy leaves, blocks stacked on axis 0."""
    opt = tree["opt"]
    return {
        "params": params_from_jax(cfg, tree["params"], device),
        "opt": {
            "m": params_from_jax(cfg, opt["m"], device),
            "v": params_from_jax(cfg, opt["v"], device),
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                 device=_device(device)),
        },
    }


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _stack_blocks(params: dict) -> dict:
    """A params-shaped tree as host numpy, its block list stacked on axis 0."""

    def stack(nodes):
        if nodes[0] is None:
            return None
        if isinstance(nodes[0], dict):
            return {key: stack([n[key] for n in nodes]) for key in nodes[0]}
        return np.stack([_host(x) for x in nodes])

    out = {key: _tree(node, _host) for key, node in params.items() if key != "blocks"}
    out["blocks"] = stack(params["blocks"])
    return out


def train_state_to_jax_layout(state: dict) -> dict:
    """``{"params", "opt": {"m", "v", "step"}}`` as host numpy in the JAX
    package's layout: each block list stacked on axis 0, step int32."""
    opt = state["opt"]
    return {
        "params": _stack_blocks(state["params"]),
        "opt": {"m": _stack_blocks(opt["m"]), "v": _stack_blocks(opt["v"]),
                "step": np.asarray(_host(opt["step"]), dtype=np.int32)},
    }


def flat_from_jax_layout(flat: dict) -> dict:
    """A checkpoint's ``/``-keyed arrays with stacked blocks (``.../blocks/
    attn/wq`` of [L, ...]) as the port's keys (``.../blocks/<i>/attn/wq``,
    views of the stacked array); every other key as it is."""
    out = {}
    for key, arr in flat.items():
        m = re.match(r"^(.*?(?:^|/)blocks)/(?!\d+(?:/|$))(.*)$", key)
        if m is None:
            out[key] = arr
            continue
        for i in range(arr.shape[0]):
            out[f"{m.group(1)}/{i}/{m.group(2)}"] = arr[i]
    return out
