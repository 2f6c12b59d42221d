"""The launch driver (``repro_torch.launch.train``) at a world above one on a
(world / N, N) mesh (``--model-axis N``: the model split over "model", the
stream's sequence too where the length divides N), held to the same command
with ``--model-axis 1`` (data parallelism alone) step for step.

  PYTHONPATH=src python tools/launcher_split.py -- --arch rwkv6-3b --steps 5
  OMP_NUM_THREADS=1 PYTHONPATH=src python tools/launcher_split.py --model-axis 2 -- \\
      --arch rwkv6-3b --reduced --steps 3 --batch 4 --seq 32 --device cpu

Runs ``torchrun --standalone --nproc_per_node NPROC -m repro_torch.launch.
train``'s loop (``launch.train.run``, this file as the program) twice, with
``--model-axis N`` and with ``--model-axis 1``; each rank writes every
step's global mean loss, its seconds in ``run`` (the build, the kernels'
compile and the steps) and its peak device GiB to a file of its own.  The
split's losses must lie within 2e-2 of the unsplit run's, relative, each
step (bf16: a world of N model ranks sums other partials than one of N data
ranks).  Prints both runs, the wall seconds of each ``torchrun``, the card's
name and power limit; exits 1 on a miss.  ``--witness-world W`` also runs
``--model-axis 1`` at world W and prints how far the unsplit run at NPROC
ranks lies from it: what the rows a rank sums alone move.

``--first-step`` instead takes the launcher's first step apart, in one
``torchrun`` of NPROC ranks on a (1, NPROC) mesh (the launcher's mesh at
``--model-axis NPROC``; at ``--nproc 1`` the whole model on one card, which
still gives its bf16 and fp32 updates and the loss after each):

  PYTHONPATH=src python tools/launcher_split.py --first-step -- --arch rwkv6-3b --steps 5

The split's first two losses through ``make_train_step`` (the launcher's
own first two), its bf16 gradients at seed 0's weights put together; then,
on rank 0, the whole model's bf16 and fp32 gradients at the same weights and
batch.  Leaf by leaf: each bf16 gradient's distance from the fp32 one, the
split's from the whole model's, the share of entries whose sign differs;
AdamW's first update (``_first_update``: the optimizer's own arithmetic)
from each gradient and the second batch's bf16 loss after it; and that loss
with the whole model's update but one leaf kind's (``tm/u``, ``cm/Wr``, ...,
over every block) taken from the split.  Writes the whole table to
``--out`` and prints the summary.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

LOSS_TOL = 2e-2


def rank_main(out_dir: str, argv: list[str]) -> None:
    import torch

    from repro_torch.launch import train as launcher

    t = time.perf_counter()
    out = launcher.run(launcher.parse_args(argv))
    seconds = time.perf_counter() - t
    cuda = torch.cuda.is_available() and "--device" not in argv
    peak = torch.cuda.max_memory_allocated() / (1 << 30) if cuda else 0.0
    rank = int(os.environ.get("RANK", 0))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "losses": out["losses"], "seconds": seconds, "peak_gib": peak}, f)


def _first_update(p0, g, clip, cfg, stepf):
    """AdamW's first update of leaf ``p0`` from gradient ``g`` (the clip
    scale ``clip``), as ``adamw_update`` computes it from zero moments:
    the amount it subtracts."""
    import torch

    gs = (g * clip).float()
    m = gs * (1 - cfg.b1)
    v = (gs * (1 - cfg.b2)) * gs
    vhat = torch.sqrt(v / (1 - cfg.b2 ** stepf)) + cfg.eps
    delta = (m / (1 - cfg.b1 ** stepf)) / vhat
    if p0.dim() >= 2:
        delta = delta + p0.float() * cfg.weight_decay
    from repro_torch.train.optimizer import schedule
    return delta * schedule(cfg, stepf)


def _kind(path: str) -> str:
    """A leaf's kind: its path inside its block (``tm/u``), else its path."""
    parts = path.strip("/").split("/")
    return "/".join(parts[2:]) if parts[0] == "blocks" else "/".join(parts)


def first_rank_main(out_path: str, argv: list[str]) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import world
    from repro_torch.launch import train as launcher
    from repro_torch.launch.sharding import gather_leaf, spec_leaves
    from repro_torch.mapreduce.executor import _device
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.optimizer import leaves

    from tensor_parallel import _grads

    args = launcher.parse_args(argv)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    opt = OptConfig(total_steps=args.steps, warmup_steps=max(5, args.steps // 20))
    with world(_device(args.device)) as (group, dev):
        rank, n = group.rank(), group.size()
        args.model_axis = n
        mesh = launcher._mesh(args, n, dev)
        pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
        b1, b2 = ({"tokens": torch.from_numpy(pipe.next_batch()).to(dev)} for _ in range(2))
        split = build_model(cfg, dev, tp=mesh)
        tp = split.tp  # None at NPROC 1: the "split" is the whole model
        seq = tp is not None and tp.over(b1["tokens"].shape[1]).seq
        params, state = init_train_state(split, 0)
        whole = ((lambda t, s: gather_leaf(t, s, mesh)) if tp is not None else (lambda t, s: t))
        specs = spec_leaves(tp.specs) if tp is not None else [None] * len(leaves(params))
        keep = (lambda t: t.to("cpu", copy=True)) if rank == 0 else (lambda t: None)
        p0 = [keep(whole(p.detach(), s)) for p, s in zip(leaves(params), specs)]
        gs = [keep(whole(g, s)) for g, s in zip(_grads(split, params, b1, torch.bfloat16), specs)]
        step = make_train_step(split, opt)
        split_losses = []
        for b in (b1, b2):
            params, state, metrics = step(params, state, b)
            split_losses.append(float(metrics["loss"]))
        del params, state, step, split
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            res = _first_step_whole(cfg, dev, opt, b1, b2, p0, gs)
            res.update({"split_losses": split_losses, "mesh": [1, n], "stream_split": seq,
                        "tokens": list(b1["tokens"].shape)})
            with open(out_path, "w") as f:
                json.dump(res, f)
        dist.barrier()


def _first_step_whole(cfg, dev, opt, b1, b2, p0, gs) -> dict:
    """Rank 0's part of ``--first-step``: the whole model at the split's
    first weights ``p0`` (whole, on the host) and its gradients ``gs``."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train.optimizer import leaves

    from tensor_parallel import _grads, _paths

    one = build_model(cfg, dev)
    params = one.init_params(0)
    names = _paths(params)
    same_init = all(torch.equal(p.cpu(), q) for p, q in zip(leaves(params), p0))
    for p in leaves(params):
        p.requires_grad_(True)
    g16 = [g.cpu() for g in _grads(one, params, b1, torch.bfloat16)]
    g32 = [g.cpu() for g in _grads(one, params, b1, torch.float32)]
    with torch.no_grad():
        loss1 = float(one.loss_fn(params, b1))
    stepf = torch.tensor(1.0, device=dev)
    p0d = [p.to(dev) for p in p0]

    def clip_of(gl):
        norm = torch.sqrt(sum(torch.sum(torch.square(g.to(dev).float())) for g in gl))
        return torch.clamp(opt.grad_clip / (norm + 1e-9), max=1.0), float(norm)

    def updates(gl):
        clip, _ = clip_of(gl)
        return [_first_update(p, g.to(dev), clip, opt, stepf) for p, g in zip(p0d, gl)]

    def loss2(deltas) -> float:
        with torch.no_grad():
            for p, q, d in zip(leaves(params), p0d, deltas):
                p.copy_(q - d)
            return float(one.loss_fn(params, b2))

    d16, ds = updates(g16), updates(gs)
    losses = {"whole_bf16": loss2(d16), "split_bf16": loss2(ds)}
    d32 = updates(g32)
    losses["whole_fp32"] = loss2(d32)
    table = []
    for name, a, b, c, u, w in zip(names, gs, g16, g32, ds, d16):
        a, b, c = (t.to(dev, torch.float64) for t in (a, b, c))
        nc, nb = float(c.norm()), float(b.norm())
        table.append({
            "leaf": name, "kind": _kind(name), "size": a.numel(), "fp32_norm": nc,
            "split_off_fp32": float((a - c).norm()) / max(nc, 1e-30),
            "whole_off_fp32": float((b - c).norm()) / max(nc, 1e-30),
            "split_off_whole": float((a - b).norm()) / max(nb, 1e-30),
            "sign_split_whole": float(((a * b) < 0).double().mean()),
            "sign_whole_fp32": float(((b * c) < 0).double().mean()),
            "update_off": float((u - w).double().norm()) / max(float(w.double().norm()), 1e-30)})
    # the whole model's update with one kind's leaves (over every block) the split's
    kinds = sorted({row["kind"] for row in table})
    swap = {k: loss2([u if row["kind"] == k else w for row, u, w in zip(table, ds, d16)])
            for k in kinds}
    # and with the fp32 gradient's update for that kind
    swap32 = {k: loss2([u if row["kind"] == k else w for row, u, w in zip(table, d32, d16)])
              for k in kinds}
    g32_n = math.sqrt(sum(row["fp32_norm"] ** 2 for row in table))

    def off(key):  # over the whole model, of the fp32 norm
        return math.sqrt(sum((row[key] * row["fp32_norm"]) ** 2 for row in table)) / g32_n

    return {"same_init": same_init, "loss1_whole_bf16": loss1, "loss2": losses,
            "clip": {k: clip_of(g)[1] for k, g in (("split", gs), ("whole_bf16", g16),
                                                     ("whole_fp32", g32))},
            "split_off_fp32": off("split_off_fp32"), "whole_off_fp32": off("whole_off_fp32"),
            "swap": swap, "swap_fp32": swap32, "table": table}


def _first_step(nproc: int, out: str, rest: list[str], card: str) -> int:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", __file__, "--first-rank-main", out, *rest]
    t = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
    wall = time.perf_counter() - t
    assert run.returncode == 0, run.stderr[-4000:]
    res = json.load(open(out))
    table = res.pop("table")
    print(f"[first-step] {' '.join(rest)} on a (1, {nproc}) mesh, tokens {res['tokens']} (the "
          f"stream's sequence split: {res['stream_split']}), {wall:.1f} s wall; the split's "
          f"losses through make_train_step {res['split_losses']}; the whole model's step-1 bf16 "
          f"loss {res['loss1_whole_bf16']!r}, the same first weights: {res['same_init']} [{card}]")
    print(f"[first-step] first gradients against fp32 over the whole model: the split's bf16 "
          f"{res['split_off_fp32']:.4g}, the whole model's {res['whole_off_fp32']:.4g} of the fp32 "
          f"norm; global norms {res['clip']} [{card}]")
    print(f"[first-step] the second batch's bf16 loss after the first AdamW update from each "
          f"gradient: {res['loss2']} [{card}]")
    kinds = sorted({row["kind"] for row in table})
    for k in kinds:
        rows = [r for r in table if r["kind"] == k]
        worst = max(rows, key=lambda r: r["split_off_whole"])
        print(f"[first-step] {k}: {len(rows)} leaves; split off fp32 <= "
              f"{max(r['split_off_fp32'] for r in rows):.3g}, whole off fp32 <= "
              f"{max(r['whole_off_fp32'] for r in rows):.3g}, split off whole <= "
              f"{worst['split_off_whole']:.3g} ({worst['leaf']}); signs split/whole differ "
              f"{max(r['sign_split_whole'] for r in rows):.3g}, whole/fp32 "
              f"{max(r['sign_whole_fp32'] for r in rows):.3g}; update off <= "
              f"{max(r['update_off'] for r in rows):.3g}; loss2 with this kind's update from the "
              f"split {res['swap'][k]:.6g}, from fp32 {res['swap_fp32'][k]:.6g}")
    res["table"] = table
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def _torchrun(nproc: int, argv: list[str]) -> tuple[list[dict], float]:
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", __file__, "--rank-main", out, *argv]
        t = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
        wall = time.perf_counter() - t
        sys.stdout.write(run.stdout)
        assert run.returncode == 0, run.stderr[-4000:]
        got = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(nproc)]
    return got, wall


def _rel(got: list[dict], want: list[dict]) -> list[float]:
    """Each step's relative distance of rank 0's losses."""
    return [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], want[0]["losses"])]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--rank-main":
        rank_main(argv[1], argv[2:])
        return 0
    if argv and argv[0] == "--first-rank-main":
        first_rank_main(argv[1], argv[2:])
        return 0
    ap = argparse.ArgumentParser(prog="tools/launcher_split.py")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--model-axis", type=int, default=4)
    ap.add_argument("--witness-world", type=int, default=0,
                    help="also run --model-axis 1 at this world, and hold it to the "
                         "--nproc run the same way (what rounding alone moves)")
    ap.add_argument("--first-step", action="store_true",
                    help="take the first step apart leaf by leaf (one run at --nproc)")
    ap.add_argument("--out", default="build/launcher_first_step.json")
    ap.add_argument("launcher", nargs=argparse.REMAINDER,
                    help="the launcher's arguments, after --")
    args = ap.parse_args(argv)
    rest = [a for a in args.launcher if a != "--"]
    card = "cpu"
    if "--device" not in rest:
        card = "; ".join(sorted(set(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines())))
    if args.first_step:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        return _first_step(args.nproc, os.path.abspath(args.out), rest, card)
    runs = {}
    for axis in (args.model_axis, 1):
        got, wall = _torchrun(args.nproc, rest + ["--mesh", "host", "--model-axis", str(axis)])
        runs[axis] = {"ranks": got, "wall_s": wall}
        print(f"[launcher] {' '.join(rest)} --model-axis {axis} on {args.nproc} ranks: losses "
              f"{got[0]['losses']}; {wall:.1f} s wall ({[round(r['seconds'], 1) for r in got]} s "
              f"in run a rank), peak {[round(r['peak_gib'], 2) for r in got]} GiB a rank [{card}]",
              flush=True)
    split, whole = runs[args.model_axis]["ranks"], runs[1]["ranks"]
    same = all(r["losses"] == split[0]["losses"] for r in split)
    rel = _rel(split, whole)
    ok = same and len(rel) == len(whole[0]["losses"]) and max(rel) <= LOSS_TOL
    print(f"[launcher] --model-axis {args.model_axis} against 1, step for step: relative "
          f"{[f'{x:.3g}' for x in rel]} (tol {LOSS_TOL}); every rank's losses the same: {same}; "
          f"ok {ok} [{card}]", flush=True)
    res = {"card": card, "runs": runs, "rel": rel, "ok": ok}
    if args.witness_world:
        got, wall = _torchrun(args.witness_world, rest + ["--mesh", "host", "--model-axis", "1"])
        res["witness"] = {"ranks": got, "wall_s": wall, "rel": _rel(whole, got)}
        print(f"[launcher] witness: --model-axis 1 at world {args.witness_world}: losses "
              f"{got[0]['losses']}; {wall:.1f} s wall, peak "
              f"{[round(r['peak_gib'], 2) for r in got]} GiB a rank; the world-{args.nproc} "
              f"unsplit run against it, step for step: relative "
              f"{[f'{x:.3g}' for x in res['witness']['rel']]} [{card}]", flush=True)
    print("RESULT " + json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
