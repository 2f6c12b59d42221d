"""Sequence parallelism cases for ``tests/test_torch_sp.py`` and its gloo
ranks: a reduced configuration of each family, batches at two lengths (16,
which divides a model axis of 2 and 4; 30, which divides 2 and not 4), one
with a prefix that only the joined sequence divides, and ``outputs`` (what a
rank, or the whole model on one rank, computes from them).  Imports nothing
of JAX.

  python tests/torch_sp_cases.py RANK WORLD STORE OUT DATA MODEL

runs every case as one rank of a (DATA, MODEL) mesh over gloo (a file store
at STORE) and writes ``OUT.<rank>.npz``."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import build_model, make_batch, mamba2, moe, rwkv6, transformer
from repro_torch.train import init_train_state
from repro_torch.train.optimizer import leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from tensor_parallel import block_entries  # noqa: E402  (the stream's shape at each block's entry)


def _cfg(name: str):
    return configs.get_config(name).reduced()


# name -> reduced config: one of each family, the vlm's and the audio
# encoder's prefixes, MoE with replica slots
CASES = {
    "olmo": lambda: _cfg("olmo-1b"),
    "internvl2": lambda: _cfg("internvl2-1b"),
    "hubert": lambda: _cfg("hubert-xlarge"),
    "qwen2": lambda: _cfg("qwen2-moe-a2.7b"),
    "rwkv6": lambda: _cfg("rwkv6-3b"),
    "zamba2": lambda: _cfg("zamba2-2.7b"),
}
BATCH = 4
LENGTHS = (16, 30)
PREFIXED = ("internvl2", 10, 6)  # 10 tokens (4 does not divide it) after 6 patches: 16
MOE = {"extra_slots": 4, "capacity_factor": 1.0}
FAMILY = {"moe": moe, "ssm": rwkv6, "hybrid": mamba2}


def family(cfg):
    """The module that runs ``cfg``'s family."""
    return FAMILY.get(cfg.family, transformer)


def batch_of(name: str, cfg, length: int) -> dict:
    if name == "prefixed":
        rng = np.random.default_rng(9)
        _, tokens, patches = PREFIXED
        return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, tokens))
                                           .astype(np.int32)),
                "prefix_embeds": torch.from_numpy(rng.normal(size=(BATCH, patches, cfg.d_model))
                                                  .astype(np.float32)).to(torch.bfloat16)}
    return make_batch(cfg, np.random.default_rng(7), BATCH, length, "cpu")


def cases():
    """(key, name, config, length) of every run."""
    out = [(f"{name}/{length}", name, make(), length) for name, make in CASES.items()
           for length in LENGTHS]
    return out + [("prefixed/16", "prefixed", CASES[PREFIXED[0]](), 16)]


def loss_kwargs(cfg, group=None) -> dict:
    return {**MOE, "group": group} if cfg.family == "moe" else {}


def outputs(cfg, model, batch: dict, rows: slice, reduce_grads=None, group=None) -> dict:
    """The stream's shapes at each block's entry, hidden states, the fp32
    loss and its gradients at seed 0's weights (``reduce_grads`` over the
    data group) for ``rows`` of ``batch``."""
    mine = {k: v[rows] for k, v in batch.items()}
    params, _ = init_train_state(model, 0)
    kw = {"dtype": torch.float32, **loss_kwargs(cfg, group)}
    with block_entries(cfg) as shapes:
        loss = family(cfg).loss_fn(cfg, params, mine, tp=model.tp, remat=False, **kw)
    loss.backward()
    # a leaf the loss does not reach (hubert's table: its input is the prefix) has none
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves(params)]
    out = {"shapes": np.array(shapes), "loss": loss.detach(),
           "grads": [g.clone() for g in (reduce_grads(grads) if reduce_grads else grads)]}
    with torch.no_grad():
        hidden = model.forward_hidden(params, mine, **kw)
        out["hidden"] = hidden[0] if cfg.family == "moe" else hidden
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
    for key, name, cfg, length in cases():
        model = build_model(cfg, "cpu", tp=mesh)
        batch = batch_of(name, cfg, length)
        got = outputs(cfg, model, batch, rows, _mean_over(group), group)
        specs = model.tp.specs
        res[f"{key}/shapes"] = got["shapes"]
        res[f"{key}/replicated"] = np.concatenate(
            [g.flatten().numpy() for g, f in zip(got["grads"], sharded_flags(specs)) if not f]
            or [np.zeros(0)])
        whole = gather_tree(_rebuild(specs, got["grads"]), specs, mesh)
        for j, leaf in enumerate(leaves(whole)):
            res[f"{key}/grads/{j}"] = leaf.numpy()
        loss = got["loss"].clone()
        dist.all_reduce(loss, group=group)
        res[f"{key}/loss"] = (loss / n).numpy()
        res[f"{key}/hidden"] = got["hidden"].numpy()
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
