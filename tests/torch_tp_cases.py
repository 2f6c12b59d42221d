"""Tensor parallelism cases shared by ``tests/test_torch_tp.py``,
``tests/test_torch_tp_recurrent.py`` and their gloo ranks: reduced
configurations, one batch, one optimizer, and ``outputs`` (what a rank, or
the whole model on one rank, computes from them); for the recurrent
families also ``lora_block`` (one RWKV-6 block under the full-size specs of
the decay LoRA).  Imports nothing of JAX.

  python tests/torch_tp_cases.py RANK WORLD STORE OUT DATA MODEL [SET]

runs every case of SET (``transformer``, the default, or ``recurrent``) as
one rank of a (DATA, MODEL) mesh over gloo (a file store at STORE) and
writes ``OUT.<rank>.npz``."""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build_model, make_batch, rwkv6, transformer
from repro_torch.serve import greedy_generate
from repro_torch.serve.engine import scan_prefill
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
# the recurrent families (tests/test_torch_tp_recurrent.py)
RECURRENT = {
    "rwkv6": lambda: _cfg("rwkv6-3b"),
    # 6 heads of 16: at model = 4 the rules cut the time mix's 96 columns
    # into 24, a head and a half a rank; every rank then runs every head
    "rwkv_mid_head": lambda: dataclasses.replace(_cfg("rwkv6-3b"), name="rwkv_mid_head",
                                                 n_heads=6, n_kv=6, d_model=96),
    # in_proj's 276 columns (z 128, x 128, B 8, C 8, dt 4) cut into 138 or 69
    "zamba2": lambda: _cfg("zamba2-2.7b"),
}
SETS = {"transformer": CASES, "recurrent": RECURRENT}
BATCH, SEQ, PROMPT, NEW = 4, 16, 6, 4
# a small clip engages the global norm at every step; no decay (the JAX
# package decays stacked [L, d] norm scales, the port's 1-D ones do not)
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.0, grad_clip=1e-3)
F32 = {"dtype": torch.float32}


def batch_of(cfg) -> dict:
    return make_batch(cfg, np.random.default_rng(7), BATCH, SEQ, "cpu")


def outputs(cfg, model, batch: dict, rows: slice, reduce_grads=None, grads=False) -> dict:
    """Hidden states, loss, prefill logits and greedy tokens of ``rows``,
    two fp32 train steps' metrics and parameters, from seed 0, and with
    ``grads`` the first step's gradients."""
    mine = {k: v[rows] for k, v in batch.items()}
    params, state = init_train_state(model, 0)
    out = {"init": [p.detach().clone() for p in leaves(params)]}
    if grads:
        model.loss_fn(params, mine, **F32).backward()
        got = [p.grad for p in leaves(params)]
        out["grads"] = [g.clone() for g in (reduce_grads(got) if reduce_grads else got)]
        for p in leaves(params):
            p.grad = None
    with torch.no_grad():
        out["hidden"] = model.forward_hidden(params, mine, remat=False, **F32)
        out["loss"] = model.loss_fn(params, mine, **F32)
        if cfg.has_decoder:
            cache = model.init_cache(rows.stop - rows.start, SEQ, torch.float32)
            if cfg.family in ("ssm", "hybrid"):  # no parallel prefill: decode steps
                out["prefill"] = scan_prefill(model, params, cache, mine["tokens"],
                                              torch.float32)[0]
            else:
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


def lora_block(mesh=None) -> dict:
    """One RWKV-6 block of the reduced config (layer 0, seed 0) on [2, 16]
    inputs, under ``mesh``'s "model" axis with the decay LoRA split as the
    full-size rules split it (the generic rule: ``wA`` on its rows, ``wB``
    on its columns, both d; no reduced config has the 2^22 elements a
    stacked leaf needs): the output, the input's gradient and the block's
    gradients (this rank's blocks) against a fixed upstream gradient."""
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.models.tensor_parallel import TensorParallel, leaf_split
    from repro_torch.models.zoo import tensor_parallel

    cfg = RECURRENT["rwkv6"]()
    whole = rwkv6.init_params(cfg, 0, "cpu")
    blk, tp = whole["blocks"][0], None
    if mesh is not None:
        specs = tensor_parallel(cfg, mesh).specs
        for spec in specs["blocks"]:
            spec["tm"]["wA"], spec["tm"]["wB"] = ("model", None), (None, "model")
        tp = TensorParallel(mesh, specs, leaf_split(specs, whole))
        blk = shard_tree(blk, specs["blocks"][0], mesh)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    up = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    x.requires_grad_(True)
    for p in leaves(blk):
        p.requires_grad_(True)
    y = rwkv6._block_apply(cfg, blk, x, tp)
    (y * up).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "grads": [p.grad for p in leaves(blk)],
            "tp": tp, "blk": blk}


def main(argv) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import gather_tree, sharded_flags
    from repro_torch.launch.train import _mean_over

    rank, world, store, out, data, model_axis, *which = argv
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    mesh = make_mesh((int(data), int(model_axis)), ("data", "model"), "cpu")
    n, i = mesh.size("data"), mesh.index("data")
    rows = slice(i * BATCH // n, (i + 1) * BATCH // n)
    res = {}
    chosen = SETS[which[0] if which else "transformer"]
    for name, make in chosen.items():
        cfg = make()
        model = build_model(cfg, "cpu", tp=mesh)
        got = outputs(cfg, model, batch_of(cfg), rows, _mean_over(mesh.group("data")),
                      grads=chosen is RECURRENT)
        specs = model.tp.specs
        # the replicated leaves as this rank holds them, then every leaf whole
        res[f"{name}/replicated"] = np.concatenate(
            [p.flatten().numpy() for p, f in zip(got["params"], sharded_flags(specs)) if not f]
            or [np.zeros(0)])
        for key in ("init", "grads", "params"):
            if key not in got:
                continue
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
    if chosen is RECURRENT:  # the decay LoRA split as at full size
        got = lora_block(mesh)
        specs = got["tp"].specs["blocks"][0]
        res["lora/y"], res["lora/dx"] = got["y"].numpy(), got["dx"].numpy()
        for j, g in enumerate(leaves(gather_tree(_rebuild(specs, got["grads"]), specs, mesh))):
            res[f"lora/grads/{j}"] = g.numpy()
        res["lora/split"] = np.array([got["tp"].split_dim("tm/wA"), got["tp"].split_dim("tm/wB"),
                                      got["blk"]["tm"]["wA"].shape[0]])
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
