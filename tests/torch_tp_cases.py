"""Tensor parallelism cases shared by ``tests/test_torch_tp.py`` and its
gloo ranks: reduced configurations, one batch, one optimizer, and
``outputs`` (what a rank, or the whole model on one rank, computes from
them).  Imports nothing of JAX.

  python tests/torch_tp_cases.py RANK WORLD STORE OUT DATA MODEL

runs every case as one rank of a (DATA, MODEL) mesh over gloo (a file
store at STORE) and writes ``OUT.<rank>.npz``."""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build_model, make_batch, transformer
from repro_torch.serve import greedy_generate
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import leaves


def _cfg(name: str):
    return configs.get_config(name).reduced()


# name -> reduced config: each family the split covers, and the rules' two
# awkward cases (see tests/test_torch_tp.py)
CASES = {
    "olmo": lambda: _cfg("olmo-1b"),
    "granite": lambda: _cfg("granite-3-8b"),
    "internvl2": lambda: _cfg("internvl2-1b"),
    "hubert": lambda: _cfg("hubert-xlarge"),
    # 6 query heads over 2 KV heads: at model = 4 the rules cut wq's 96
    # columns into 24, a head and a half; every rank then attends with all
    "mid_head": lambda: dataclasses.replace(_cfg("granite-3-8b"), name="mid_head", n_heads=6),
    # a vocab of 4,099 (no split) and 4,099 x 1,024 >= 2^22 elements: the
    # generic rule splits the tied table on d
    "d_table": lambda: dataclasses.replace(_cfg("granite-3-8b"), name="d_table", vocab=4099,
                                           d_model=1024, n_layers=1),
}
BATCH, SEQ, PROMPT, NEW = 4, 16, 6, 4
# a small clip engages the global norm at every step; no decay (the JAX
# package decays stacked [L, d] norm scales, the port's 1-D ones do not)
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0, grad_clip=1e-3)
F32 = {"dtype": torch.float32}


def batch_of(cfg) -> dict:
    return make_batch(cfg, np.random.default_rng(7), BATCH, SEQ, "cpu")


def outputs(cfg, model, batch: dict, rows: slice, reduce_grads=None) -> dict:
    """Hidden states, loss, prefill logits and greedy tokens of ``rows``,
    and two fp32 train steps' metrics and parameters, from seed 0."""
    mine = {k: v[rows] for k, v in batch.items()}
    params, state = init_train_state(model, 0)
    out = {"init": [p.detach().clone() for p in leaves(params)]}
    with torch.no_grad():
        out["hidden"] = model.forward_hidden(params, mine, remat=False, **F32)
        out["loss"] = model.loss_fn(params, mine, **F32)
        if cfg.has_decoder:
            cache = model.init_cache(rows.stop - rows.start, SEQ, torch.float32)
            out["prefill"] = transformer.prefill(cfg, params, mine["tokens"], cache,
                                                 torch.float32, tp=model.tp)[0]
            out["greedy"] = torch.from_numpy(greedy_generate(
                model, params, mine["tokens"][:, :PROMPT].numpy(), NEW, dtype=torch.float32))
    step = make_train_step(model, OPT, F32, reduce_grads)
    metrics = []
    for _ in range(2):
        params, state, m = step(params, state, mine)
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    out["metrics"] = torch.stack(metrics)
    out["params"] = [p.detach().clone() for p in leaves(params)]
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
    res = {}
    for name, make in CASES.items():
        cfg = make()
        model = build_model(cfg, "cpu", tp=mesh)
        got = outputs(cfg, model, batch_of(cfg), rows, _mean_over(mesh.group("data")))
        specs = model.tp.specs
        # the replicated leaves as this rank holds them, then every leaf whole
        res[f"{name}/replicated"] = np.concatenate(
            [p.flatten().numpy() for p, f in zip(got["params"], sharded_flags(specs)) if not f]
            or [np.zeros(0)])
        for key in ("init", "params"):
            whole = gather_tree(_rebuild(specs, got[key]), specs, mesh)
            for j, leaf in enumerate(leaves(whole)):
                res[f"{name}/{key}/{j}"] = leaf.numpy()
        loss = got["loss"].clone()
        dist.all_reduce(loss, group=mesh.group("data"))
        res[f"{name}/loss"] = (loss / n).numpy()
        metrics = got["metrics"].clone()
        dist.all_reduce(metrics, group=mesh.group("data"))
        res[f"{name}/metrics"] = (metrics / n).numpy()
        for key in ("hidden", "prefill", "greedy"):
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
