"""MoE training under data parallelism across several ranks: the launcher's
step with ``moe_ffn``'s group (the aux loss and the replica plan of the
global batch) over NCCL, one card a rank, against one rank's run of the
whole batch, and the step time with the group and without it.

  PYTHONPATH=src torchrun --standalone --nproc_per_node 4 tools/moe_dp.py
  OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone --nproc_per_node 2 \
      tools/moe_dp.py --device cpu --reduced --layers 2 --seq 32 --steps 2

qwen2-moe-a2.7b at full width (``--reduced``: its reduced config), cut to
``--layers`` layers, weights from seed 0 on every rank, extra slots 8 and
capacity factor 1.25 (the launcher's defaults).

1. Check, fp32 with TF32 off: each rank takes its row of a [world,
   ``--check-seq``] batch and runs ``loss_fn`` with the group and its
   backward; the loss and every layer's router gradient, averaged over the
   ranks as the launcher averages them (``launch.train._mean_over``), are
   held against rank 0's run of the whole batch with no group: the loss to
   1e-5 relative, each router gradient to 1e-4 of its largest entry (the
   ranks' products run at another batch size, so in another order).  The
   tokens whose top-k experts differ between the two runs are counted a
   layer: where the last bits of a logit decide a near-tie the other way,
   one token's choice moves, and with it a few per cent of a router
   gradient's largest entry, so the gradients are held only where no
   choice moved (the count says which).  Beside them, the ranks' own
   losses averaged without the group: what the launcher computed before
   the group was passed.
2. Time: ``--steps`` bf16 train steps of [``--batch``, ``--seq``] a rank,
   the launcher's step (``make_train_step`` with ``_mean_over``), with the
   group in the loss and without it, in turns; each step between a barrier
   and a synchronise; the median ms of each.

Rank 0 prints the card and one JSON line.  Exits non-zero when the check
misses its tolerance.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import world
from repro_torch.launch.train import _mean_over
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import leaves

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--check-seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    cfg = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg.reduced() if args.reduced else cfg, n_layers=args.layers)
    kw = {"extra_slots": 8, "capacity_factor": 1.25}
    torch.backends.cuda.matmul.allow_tf32 = False
    with world(args.device) as (group, dev):
        rank, n = group.rank(), group.size()
        model = build_model(cfg, device=dev)
        params, opt_state = init_train_state(model, 0)
        routers = [blk["router"] for blk in params["blocks"]]
        route, choices = moe.route, []

        def recorded_route(*a, **k):
            out = route(*a, **k)
            choices.append(out[2].detach())
            return out

        moe.route = recorded_route

        def loss_and_routers(tokens, grp):
            """The loss, every layer's router gradient, and every layer's
            top-k experts [B, L, k] (sorted) of the forward (the backward's
            recompute routes again)."""
            for p in leaves(params):
                p.grad = None
            choices.clear()
            loss = model.loss_fn(params, {"tokens": tokens}, dtype=torch.float32, group=grp,
                                 **kw)
            loss.backward()
            topk = [c.sort(-1).values for c in choices[:cfg.n_layers]]
            return loss.detach(), [r.grad.clone() for r in routers], topk

        def mean(t):
            t = t.clone()
            dist.all_reduce(t, group=group)
            return t / n

        # ---- 1. the check ----------------------------------------------------
        rng = np.random.default_rng(1)
        whole = torch.from_numpy(rng.integers(0, cfg.vocab, (n, args.check_seq))
                                 .astype(np.int32)).to(dev)
        loss, grads, topk = loss_and_routers(whole[rank:rank + 1], group)
        loss, grads = mean(loss), [mean(g) for g in grads]
        gathered = []
        for t in topk:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            gathered.append(torch.cat(parts))
        own = mean(loss_and_routers(whole[rank:rank + 1], None)[0])
        check = None
        if rank == 0:
            want, want_grads, want_topk = loss_and_routers(whole, None)
            rel = lambda x: float((x - want).abs() / want.abs())  # noqa: E731
            check = {
                "loss": float(want), "loss_rel_err": rel(loss), "own_loss_rel_err": rel(own),
                "moved_choices": [int((a != b).any(-1).sum()) for a, b in zip(gathered, want_topk)],
                "tokens_a_layer": n * args.check_seq,
                "router_grad_err": [float((g - w).abs().max() / w.abs().max())
                                    for g, w in zip(grads, want_grads)]}
        moe.route = route
        for p in leaves(params):
            p.grad = None
        del grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- 2. step time with the group and without it ------------------------
        opt_cfg = OptConfig(total_steps=1000, warmup_steps=5)
        steps = {"with_group": make_train_step(model, opt_cfg, {**kw, "group": group},
                                               reduce_grads=_mean_over(group)),
                 "without_group": make_train_step(model, opt_cfg, kw,
                                                  reduce_grads=_mean_over(group))}
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (n * args.batch, args.seq))
                                  .astype(np.int32)[rank * args.batch:(rank + 1) * args.batch]
                                  ).to(dev)
        ms = {name: [] for name in steps}
        for i in range(args.steps + 1):  # the first round warms both up
            for name in sorted(steps, reverse=bool(i % 2)):
                dist.barrier(group)
                _sync(dev)
                t = time.perf_counter()
                params, opt_state, _ = steps[name](params, opt_state, {"tokens": tokens})
                _sync(dev)
                if i:
                    ms[name].append((time.perf_counter() - t) * 1e3)
        if rank == 0:
            smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True, timeout=60).stdout.strip().splitlines()[0]
                   if dev.type == "cuda" else "cpu")
            print(smi)
            print(json.dumps({
                "world": n, "layers": cfg.n_layers, "reduced": args.reduced,
                "check_shape": [n, args.check_seq], "step_shape": [n * args.batch, args.seq],
                **check, "ms": {k: statistics.median(v) for k, v in ms.items()},
                "ms_all": ms}), flush=True)
            loss_held = check["loss_rel_err"] <= LOSS_TOL
            moved = any(check["moved_choices"])
            if max(check["router_grad_err"]) <= GRAD_TOL:
                grads = "held"
            elif moved:
                grads = f"not comparable: tokens routed apart {check['moved_choices']}"
            else:
                grads = "FAILED with every choice equal"
            print(f"loss {'held' if loss_held else 'FAILED'}; router gradients {grads}",
                  flush=True)
            return 0 if loss_held and not grads.startswith("FAILED") else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
