"""Expert parallelism cases shared by ``tests/test_torch_ep.py`` and its
gloo ranks: reduced MoE configurations, each with its replica slots, one
batch, one layer input, one optimizer, and ``outputs`` (what a rank, or
the whole model on one rank, computes from them).  Imports nothing of JAX.

  python tests/torch_ep_cases.py RANK WORLD STORE OUT DATA MODEL

runs every case as one rank of a (DATA, MODEL) mesh over gloo (a file
store at STORE) and writes ``OUT.<rank>.npz``."""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build_model, make_batch, moe
from repro_torch.serve import greedy_generate
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import leaves


def _cfg(arch: str, **kw):
    cfg = configs.get_config(arch).reduced()
    return dataclasses.replace(cfg, **kw) if kw else cfg


# name -> (reduced config, replica slots): both MoE configurations (8
# experts, top 2; qwen2 with a shared expert) with and without replica
# slots, and the two awkward cases (see tests/test_torch_ep.py)
CASES = {
    "qwen2_x0": (lambda: _cfg("qwen2-moe-a2.7b"), 0),
    "qwen2_x4": (lambda: _cfg("qwen2-moe-a2.7b"), 4),
    "qwen3_x0": (lambda: _cfg("qwen3-moe-30b-a3b"), 0),
    "qwen3_x4": (lambda: _cfg("qwen3-moe-30b-a3b"), 4),
    # 6 replica slots: at model = 4 the replica dim does not divide, and
    # the group's first rank computes every replica slot
    "x6": (lambda: _cfg("qwen2-moe-a2.7b"), 6),
    # 6 experts: at model = 4 they do not divide, and every rank runs every
    # slot on its 8 of the expert width's 32 columns
    "e6": (lambda: _cfg("qwen2-moe-a2.7b", name="e6", n_experts=6), 4),
}
BATCH, SEQ, PROMPT, NEW = 4, 32, 6, 4
LAYER_SEQ = 64  # layer 0's input: 2 x 64 choices a sequence over 8 experts; every expert needs a replica
# capacity tight enough that the slots overflow and the replica plan grants
CF = 1.0
# a small clip engages the global norm at every step; no decay (the JAX
# package decays stacked [L, d] norm scales, the port's 1-D ones do not)
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0, grad_clip=1e-3)


def batch_of(cfg) -> dict:
    return make_batch(cfg, np.random.default_rng(7), BATCH, SEQ, "cpu")


def layer_input(cfg) -> torch.Tensor:
    """One MoE layer's input [BATCH, LAYER_SEQ, d], for the dispatch's
    integers."""
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.normal(size=(BATCH, LAYER_SEQ, cfg.d_model)).astype(np.float32))


def outputs(cfg, extra: int, model, rows: slice, group=None, reduce_grads=None) -> dict:
    """From seed 0 on ``rows`` of the batch: hidden states, aux and loss;
    layer 0's output on ``layer_input`` and its dispatch (slot loads,
    dropped choices, each slot's expert); the first step's gradients;
    two fp32 clipped steps' metrics and parameters; greedy tokens.
    ``group``: the data group (the replica plan is the global batch's)."""
    kw = {"dtype": torch.float32, "capacity_factor": CF, "extra_slots": extra, "group": group}
    mine = {k: v[rows] for k, v in batch_of(cfg).items()}
    params, state = init_train_state(model, 0)
    out = {"init": [p.detach().clone() for p in leaves(params)]}
    with torch.no_grad():
        hidden, aux = model.forward_hidden(params, mine, remat=False, **kw)
        out["hidden"], out["aux"] = hidden, aux
        y, _, st = moe.moe_ffn(params["blocks"][0], layer_input(cfg)[rows], cfg, CF, extra,
                               return_stats=True, group=group, tp=model.tp)
        out["layer"] = y
        out["slot_loads"] = st["slot_loads"]
        out["dropped"] = st["dropped"].reshape(1)
        if extra:
            out["slot_expert"] = st["slot_expert"]
    with torch.enable_grad():
        loss = model.loss_fn(params, mine, **kw)
        loss.backward()
    grads = [p.grad for p in leaves(params)]
    grads = reduce_grads(grads) if reduce_grads else grads
    out["loss"], out["grads"] = loss.detach(), [g.clone() for g in grads]
    step = make_train_step(model, OPT, kw, reduce_grads)
    metrics = []
    for _ in range(2):
        params, state, m = step(params, state, mine)
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    out["metrics"] = torch.stack(metrics)
    out["params"] = [p.detach().clone() for p in leaves(params)]
    with torch.no_grad():
        out["greedy"] = torch.from_numpy(greedy_generate(
            model, params, mine["tokens"][:, :PROMPT].numpy(), NEW, dtype=torch.float32))
    return out


def main(argv) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import gather_tree, sharded_flags
    from repro_torch.launch.train import _mean_over

    rank, world, store, out, data, model_axis = argv
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    mesh = make_mesh((int(data), int(model_axis)), ("data", "model"), "cpu")
    n, i = mesh.size("data"), mesh.index("data")
    rows = slice(i * BATCH // n, (i + 1) * BATCH // n)
    group = mesh.group("data")
    res = {}
    for name, (make, extra) in CASES.items():
        cfg = make()
        model = build_model(cfg, "cpu", tp=mesh)
        got = outputs(cfg, extra, model, rows, group, _mean_over(group))
        specs = model.tp.specs
        # the replicated leaves as this rank holds them, then every leaf whole
        res[f"{name}/replicated"] = np.concatenate(
            [p.flatten().numpy() for p, f in zip(got["params"], sharded_flags(specs)) if not f])
        for key in ("init", "grads", "params"):
            whole = gather_tree(_rebuild(specs, got[key]), specs, mesh)
            for j, leaf in enumerate(leaves(whole)):
                res[f"{name}/{key}/{j}"] = leaf.numpy()
        for key in ("loss", "aux", "metrics", "slot_loads", "dropped"):
            x = got[key].clone()
            dist.all_reduce(x, group=group)  # the data groups' mean, or sum for the integers
            res[f"{name}/{key}"] = (x if key in ("slot_loads", "dropped") else x / n).numpy()
        for key in ("hidden", "layer", "greedy", "slot_expert"):
            if key in got:
                res[f"{name}/{key}"] = got[key].numpy()
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()


def _rebuild(specs, flat: list):
    """A params-shaped tree with ``flat``'s tensors, in ``leaves`` order."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, list):
            return [build(sub) for sub in node]
        return next(it)

    return build(specs)


if __name__ == "__main__":
    sys.modules["jax"] = None  # the port runs without JAX
    main(sys.argv[1:])
