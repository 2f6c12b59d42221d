"""Production training launcher: the port of ``repro.launch.train``.

Wires together: config -> model -> mesh -> train step with a data-parallel
gradient mean -> token pipeline -> checkpoints -> preemption handling.  The
JAX package's flags, plus ``--device`` (``cuda`` unless ``cpu`` is asked
for):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train ...

``--mesh host`` (the JAX package's dev-box path) is data parallelism over
every rank of the default group: one process at a world of one, or
``torchrun``'s ranks (``repro_torch.distributed.world`` starts the group:
NCCL on the card, each rank on ``cuda:{LOCAL_RANK}``; gloo on the CPU).
Every rank builds the same parameters from seed 0, takes its contiguous
rows of the ``TokenPipeline``'s global batch (``--batch`` rows, a multiple
of the world size), and the gradients are averaged by one ``all_reduce`` a
leaf, in the order of the parameter tree, before every rank runs the same
``adamw_update``.  At a world of one the mean is the gradient itself, bit
for bit, so the launcher's steps are ``make_train_step``'s.  Above one
rank the mean is exact for a loss that is a mean over independent rows
(the dense, ssm and hybrid families, and MoE's cross entropy).  MoE's
load-balance aux loss is a product of two batch means (each expert's share
of the routed choices and its mean router probability): the launcher
hands its group to the MoE ``loss_fn``, whose ``moe_ffn`` adds both sums
over the ranks before the product, so every rank's aux is the global
batch's, as the JAX package's SPMD host mesh computes it.  Rank 0 writes
the checkpoints (``AsyncCheckpointer``, the JAX package's layout, so either
package resumes the other's); ``--resume`` restores the latest through
``restore_tree`` on every rank and continues the pipeline at its step.
``PreemptionGuard``: SIGTERM checkpoints at the next step boundary and
exits (at a world above one, the ranks agree on the step by a MAX
``all_reduce`` of the flag).  Rank 0 prints the log: where training
starts, every tenth step's global mean loss, exactly (``repr``), and tokens
a second, and at the end the kernels' launch counts (``kernels.launches``:
on the card, K6/K6b or K7/K7b ran).

``--mesh prod`` and ``--mesh prod-multipod`` train on the JAX package's
(16, 16) and (2, 16, 16) meshes (below 256 / 512 ranks they raise, naming
the world size); ``--model-axis N`` makes ``--mesh host`` a (world / N, N)
("data", "model") mesh, and ``run(args, mesh)`` trains on any mesh of
``launch.mesh.make_mesh``.  Over "model" every family splits as the rules
place each leaf (``models.tensor_parallel``: tensor parallelism; for moe
expert parallelism with the ``--extra-slots`` replica slots spread over
the ranks; for ssm and hybrid the RWKV-6 and Mamba2 heads; no FSDP, as the
JAX launcher).  The data axes carry the rows:
each data group takes its rows of the global batch, the gradients are
averaged over the data group, and the logged loss is the data group's mean
(every rank of a model group holds the same loss).  A checkpoint holds the
whole model in the JAX layout (the model group's blocks gathered before
rank 0 writes), and ``--resume`` gives each rank its blocks of it, so a run
resumes onto another mesh shape.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed import world
from repro_torch.kernels import launches
from repro_torch.mapreduce.executor import _device
from repro_torch.models import build_model
from repro_torch.models.convert import flat_from_jax_layout, train_state_to_jax_layout
from repro_torch.train import (
    AsyncCheckpointer,
    OptConfig,
    PreemptionGuard,
    init_train_state,
    latest_step,
    load_checkpoint,
    make_train_step,
    restore_tree,
)
from repro_torch.train.optimizer import leaves

from .mesh import make_host_mesh, make_mesh, make_production_mesh
from .sharding import gather_tree


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", choices=("host", "prod", "prod-multipod"), default="host")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="--mesh host: ranks on the 'model' axis of a (world / N, N) mesh")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--extra-slots", type=int, default=8, help="MoE SharesSkew replicas")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _mean_over(group: dist.ProcessGroup):
    """The gradient tree's mean over ``group``'s ranks: one SUM
    ``all_reduce`` a leaf, in ``leaves`` order, then a division by the
    world size (in place)."""
    n = group.size()

    def reduce(grads):
        for g in leaves(grads):
            dist.all_reduce(g, group=group)
            g.div_(n)
        return grads

    return reduce


def _mesh(args: argparse.Namespace, world_size: int, dev: torch.device):
    if args.mesh != "host":
        return make_production_mesh(multi_pod=args.mesh == "prod-multipod", device=dev)
    if args.model_axis == 1:
        return make_host_mesh("data", dev)
    if world_size % args.model_axis:
        raise ValueError(f"--model-axis {args.model_axis} does not divide {world_size} ranks")
    return make_mesh((world_size // args.model_axis, args.model_axis), ("data", "model"), dev)


def run(args: argparse.Namespace, mesh=None) -> dict:
    """The training loop on ``mesh`` (default: the one ``args`` names, over
    the default group); returns {"start", "losses" (the global mean loss of
    each step run, as floats), "params", "opt"} of this rank (its blocks)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    with world(_device(args.device)) as (group, dev):
        if mesh is None:
            mesh = _mesh(args, group.size(), dev)
        rank = group.rank()
        data = mesh.data_axes
        data_group, n = mesh.group(data), mesh.size(data)
        if args.batch % n:
            raise ValueError(f"--batch {args.batch} does not split over {n} data ranks")
        i = mesh.index(data)
        rows = slice(i * args.batch // n, (i + 1) * args.batch // n)
        model = build_model(cfg, device=dev, tp=mesh)
        specs = None
        if model.tp is not None:
            specs = {"params": model.tp.specs,
                     "opt": {"m": model.tp.specs, "v": model.tp.specs, "step": ()}}

        opt_cfg = OptConfig(total_steps=args.steps, warmup_steps=max(5, args.steps // 20))
        loss_kwargs = ({"extra_slots": args.extra_slots, "group": data_group}
                       if cfg.family == "moe" else {})
        step_fn = make_train_step(model, opt_cfg, loss_kwargs,
                                  reduce_grads=_mean_over(data_group))
        params, opt_state = init_train_state(model, 0)

        pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
        start = 0
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3) if args.ckpt_dir and rank == 0 else None
        if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            start, flat = load_checkpoint(args.ckpt_dir)
            tree = restore_tree({"params": params, "opt": opt_state},
                                flat_from_jax_layout(flat), device=dev, specs=specs, mesh=mesh)
            params, opt_state = tree["params"], tree["opt"]
            for p in leaves(params):
                p.requires_grad_(True)
            pipe.step = start
            if rank == 0:
                print(f"resumed from step {start} (mesh {tuple(mesh.shape)} over "
                      f"{mesh.mesh_dim_names})", flush=True)

        losses = []
        try:
            with PreemptionGuard() as guard:
                if rank == 0:
                    print(f"training {cfg.name} from step {start} to {args.steps} on "
                          f"{group.size()} rank(s) of {dev.type}, mesh "
                          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
                t0 = time.time()
                for step in range(start, args.steps):
                    tokens = torch.from_numpy(pipe.next_batch()[rows]).to(dev)
                    params, opt_state, metrics = step_fn(params, opt_state, {"tokens": tokens})
                    loss = metrics["loss"].detach().clone()
                    dist.all_reduce(loss, group=data_group)
                    losses.append(loss / n)
                    if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
                        tput = (step - start + 1) * args.batch * args.seq / (time.time() - t0)
                        print(f"step {step:5d} loss={float(losses[-1])!r} tok/s={tput:.0f}",
                              flush=True)
                    stop = guard.should_stop
                    if group.size() > 1:
                        flag = torch.tensor(int(stop), device=dev)
                        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
                        stop = bool(flag)
                    if args.ckpt_dir and (stop or (step + 1) % args.ckpt_every == 0):
                        state = {"params": params, "opt": opt_state}
                        if specs is not None:  # every rank takes part in the gather
                            state = gather_tree(state, specs, mesh)
                        if ckpt:
                            ckpt.save(step + 1, train_state_to_jax_layout(state))
                        del state
                    if stop:
                        if rank == 0:
                            print("preempted -> checkpointed", flush=True)
                        break
        finally:
            if ckpt:
                ckpt.wait()
        if rank == 0:
            print(f"kernel launches {launches()}", flush=True)
        return {"start": start, "losses": [float(x) for x in losses], "params": params,
                "opt": opt_state}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
