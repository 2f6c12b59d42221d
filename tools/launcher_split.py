"""The launch driver (``repro_torch.launch.train``) at a world above one on a
(world / N, N) mesh (``--model-axis N``: the model split over "model", the
stream's sequence too where the length divides N), held to the same command
with ``--model-axis 1`` (data parallelism alone) step for step.

  PYTHONPATH=src python tools/launcher_split.py -- --arch rwkv6-3b --steps 5 --seq 127
  PYTHONPATH=src python tools/launcher_split.py --fp32 --layers 12 -- --arch rwkv6-3b \\
      --steps 5 --seq 127
  OMP_NUM_THREADS=1 PYTHONPATH=src python tools/launcher_split.py --model-axis 2 -- \\
      --arch rwkv6-3b --reduced --steps 3 --batch 4 --seq 31 --device cpu

Runs ``torchrun --standalone --nproc_per_node NPROC -m repro_torch.launch.
train``'s loop (``launch.train.run``, this file as the program) twice, with
``--model-axis N`` and with ``--model-axis 1``; each rank writes every
step's global mean loss, its seconds in ``run`` (the build, the kernels'
compile and the steps), its peak device GiB, the stream's shape at a
block's entry and the kernels' launch counts to a file of its own.  The
split's losses must lie within 2e-2 of the unsplit run's, relative, each
step (bf16: a world of N model ranks sums other partials than one of N data
ranks).  Prints both runs, the wall seconds of each ``torchrun``, the card's
name and power limit; exits 1 on a miss.  ``--witness-world W`` also runs
``--model-axis 1`` at world W and prints how far the unsplit run at NPROC
ranks lies from it: what the rows a rank sums alone move.  ``--split-only``
runs the split launch alone (a model whose whole does not fit one card).

``--fp32 [--layers L]`` runs both launches in fp32 (``run(dtype=)``) on the
configuration cut to depth L (``run(cfg=)``): a depth where fp32 is a truth,
so the check is one that rounding cannot pass off as noise.  The first
step's loss must lie within ``tools/tensor_parallel.py``'s 1e-5 relative
and every gradient (the data group's mean, put together whole from the
model group) within its 1e-4 of the leaf's largest entry; this decides the
exit code.  Beside it, the float64 witness: the unsplit launch's rank 0
starts ``f64_first_step`` on the CPU from its first weights and the global
first batch, and each run's worst leaf is held to it (the split within the
unsplit run's error plus 1e-4).

``--first-step`` instead takes the launcher's first step apart, in one
``torchrun`` of NPROC ranks on a (1, NPROC) mesh (the launcher's mesh at
``--model-axis NPROC``; at ``--nproc 1`` the whole model on one card, which
still gives its bf16 and fp32 updates and the loss after each):

  PYTHONPATH=src python tools/launcher_split.py --first-step -- --arch rwkv6-3b \\
      --steps 5 --seq 127

The split's first two losses through ``make_train_step`` (the launcher's
own first two), its bf16 gradients at seed 0's weights put together; then,
on rank 0, the whole model's bf16 and fp32 gradients at the same weights and
batch, and its bf16 gradient with each of NPROC data ranks' rows alone, then
averaged (the split-free second rounding: what ``--model-axis 1`` computes).
Leaf by leaf: each bf16 gradient's distance from the fp32 one, the split's
from the whole model's, the share of entries whose sign differs; AdamW's
first update (``_first_update``: the optimizer's own arithmetic) from each
gradient and the second batch's bf16 loss after it; the same-weights factor
(a gradient's distance from fp32 over the whole model's bf16 one; phases 58
and 60 hold it to 2) for the split and the rows alone, leaf kind by leaf
kind (``tm/u``, ``cm/Wr``, ..., over every block); and that loss with the
whole model's update but one leaf kind's taken from the split.  Beside it,
the float64 witness of the whole model's first gradient (rank 0 starts it
on the CPU while the cards work; not where the host's disk cannot hold its
weights) and the factor against it.  Writes the whole table to ``--out``
and prints the summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

LOSS_TOL = 2e-2
GRAD_TOL = 1e-4  # tools/tensor_parallel.py's, as the float64 witness's margin
FACTOR = 2.0  # phases 58 and 60's same-weights factor


def _cfg_of(argv: list[str], layers: int):
    """The launcher's configuration for ``argv``, cut to ``layers`` (0: its
    own depth)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher

    args = launcher.parse_args(argv)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def rank_main(out_dir: str, dtype: str, layers: int, argv: list[str],
              witness: bool = False) -> None:
    """One rank of a launch: ``launch.train.run`` in ``dtype`` ("bf16" or
    "fp32") at depth ``layers``; writes its losses, seconds, peak GiB, the
    stream's shape at the first block's entry and the kernels' launch
    counts.  In fp32 rank 0 also saves the first step's gradients (the data
    group's mean, each leaf put together whole from the model group); with
    ``witness`` (the unsplit launch), it starts the float64 witness of the
    first step on the CPU (``f64_first_step``, detached: the tool waits for
    it) from the first weights and the global first batch."""
    import torch
    import torch.distributed as dist

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import launches
    from repro_torch.launch import train as launcher
    from repro_torch.launch.sharding import gather_leaf, spec_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import leaves

    from tensor_parallel import block_entries

    args = launcher.parse_args(argv)
    cfg = _cfg_of(argv, layers)
    fp32 = dtype == "fp32"
    cuda = torch.cuda.is_available() and "--device" not in argv
    if fp32 and cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ.get("RANK", dist.get_rank() if dist.is_initialized() else 0))
    first: list = []

    def train_step(model, opt_cfg, loss_kwargs=None, reduce_grads=None):
        """The launcher's step, the first step's mean gradient kept whole."""

        def reduce(grads):
            grads = reduce_grads(grads)
            if fp32 and not first:
                tp = model.tp
                specs = spec_leaves(tp.specs) if tp is not None else [None] * len(
                    leaves(grads))
                whole = [gather_leaf(g, s, tp.mesh) if tp is not None else g
                         for g, s in zip(leaves(grads), specs)]
                first.append([g.detach().cpu() for g in whole] if rank == 0 else None)
            return grads

        step = make_train_step(model, opt_cfg, loss_kwargs, reduce)
        if not (witness and rank == 0 and model.tp is None):
            return step

        def first_witnessed(params, opt_state, batch):
            if not first:  # the first weights, before the first update
                tokens = torch.from_numpy(TokenPipeline(
                    vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0).next_batch())
                _start_f64(os.path.join(out_dir, "witness.json"),
                           [p.detach().cpu() for p in leaves(params)], tokens, argv, layers,
                           detach=True)
            return step(params, opt_state, batch)

        return first_witnessed

    launcher.make_train_step = train_step
    t = time.perf_counter()
    with block_entries(cfg) as shapes:
        out = launcher.run(args, dtype=torch.float32 if fp32 else torch.bfloat16, cfg=cfg)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / (1 << 30) if cuda else 0.0
    if fp32 and rank == 0:
        torch.save(first[0], os.path.join(out_dir, "grads.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "losses": out["losses"], "seconds": seconds, "peak_gib": peak,
                   "stream": shapes[0] if shapes else None, "layers": cfg.n_layers,
                   "launches": launches()}, f)


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


def f64_first_step(in_path: str, out_path: str, argv: list[str]) -> None:
    """The whole model's first gradient in float64 on the CPU, at the
    weights and batch rank 0 wrote to ``in_path``: fp32 leaves, every fp32
    of the model's code read as float64 for this process
    (``tools/bf16_reference.py``'s ``f64_worker``)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.kernels.wkv6 as k7
    from repro_torch.launch import train as launcher
    from repro_torch.models import build_model
    from repro_torch.train.compression import _unflatten
    from repro_torch.train.optimizer import leaves

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 4))
    got = torch.load(in_path)
    cfg = _cfg_of(argv, got.get("layers", 0))
    model = build_model(cfg, "cpu")
    with FakeTensorMode():
        template = model.init_params(0)
    params = _unflatten(template, iter(got["p0"]))
    tokens = got["tokens"]
    del got
    torch.Tensor.float = torch.Tensor.double
    torch.float32 = torch.float64
    k7.INPUT_DTYPES = k7.INPUT_DTYPES + (torch.float64,)
    for p in leaves(params):
        p.requires_grad_(True)
    args = launcher.parse_args(argv)
    kw = {"extra_slots": args.extra_slots} if cfg.family == "moe" else {}  # the launcher's
    try:
        loss = model.loss_fn(params, {"tokens": tokens}, dtype=torch.float64, **kw)
        loss.backward()
        torch.save({"loss": float(loss.detach()), "grads": [p.grad for p in leaves(params)]},
                   out_path + ".part")
        os.replace(out_path + ".part", out_path)
    except BaseException as e:
        with open(out_path + ".err", "w") as f:
            f.write(repr(e))
        raise


def _start_f64(out_path: str, p0: list, tokens, argv: list[str], layers: int = 0,
               detach: bool = False):
    """Rank 0's float64 witness of the first step, started on the CPU while
    the cards work: (the process, the stem of its files: ``_f64_in.pt``,
    then ``_f64.pt``), or None where the host's disk cannot hold the
    weights and the gradients.  ``detach``: in a session of its own, so
    that it outlives the ``torchrun`` that started it."""
    import torch

    base = os.path.splitext(out_path)[0]
    need = 2 * sum(p.numel() * 4 for p in p0)
    if shutil.disk_usage(os.path.dirname(out_path)).free < 2 * need:
        return None
    torch.save({"p0": p0, "tokens": tokens.cpu(), "layers": layers}, base + "_f64_in.pt")
    proc = subprocess.Popen([sys.executable, __file__, "--f64-first-step", base + "_f64_in.pt",
                             base + "_f64.pt", *argv], start_new_session=detach)
    return proc, base


def first_rank_main(out_path: str, layers: int, argv: list[str]) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import world
    from repro_torch.launch import train as launcher
    from repro_torch.launch.sharding import gather_leaf, spec_leaves
    from repro_torch.mapreduce.executor import _device
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, init_train_state, make_train_step
    from repro_torch.train.optimizer import leaves

    from tensor_parallel import _grads, block_entries

    args = launcher.parse_args(argv)
    cfg = _cfg_of(argv, layers)
    opt = OptConfig(total_steps=args.steps, warmup_steps=max(5, args.steps // 20))
    with world(_device(args.device)) as (group, dev):
        rank, n = group.rank(), group.size()
        args.model_axis = n
        mesh = launcher._mesh(args, n, dev)
        pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
        b1, b2 = ({"tokens": torch.from_numpy(pipe.next_batch()).to(dev)} for _ in range(2))
        split = build_model(cfg, dev, tp=mesh)
        tp = split.tp  # None at NPROC 1: the "split" is the whole model
        params, state = init_train_state(split, 0)
        whole = ((lambda t, s: gather_leaf(t, s, mesh)) if tp is not None else (lambda t, s: t))
        specs = spec_leaves(tp.specs) if tp is not None else [None] * len(leaves(params))
        keep = (lambda t: t.to("cpu", copy=True)) if rank == 0 else (lambda t: None)
        p0 = [keep(whole(p.detach(), s)) for p, s in zip(leaves(params), specs)]
        witness = _start_f64(out_path, p0, b1["tokens"], argv, layers) if rank == 0 else None
        with block_entries(cfg) as shapes:
            grads = _grads(split, params, b1, torch.bfloat16)
        gs = [keep(whole(g, s)) for g, s in zip(grads, specs)]
        del grads
        step = make_train_step(split, opt)
        split_losses = []
        for b in (b1, b2):
            params, state, metrics = step(params, state, b)
            split_losses.append(float(metrics["loss"]))
        del params, state, step, split
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            stream = shapes[0]
            res = _first_step_whole(cfg, dev, opt, b1, b2, p0, gs, n, witness)
            res.update({"split_losses": split_losses, "mesh": [1, n], "stream": stream,
                        "stream_split": stream[1] != b1["tokens"].shape[1],
                        "tokens": list(b1["tokens"].shape)})
            with open(out_path, "w") as f:
                json.dump(res, f)
        dist.barrier()


def _first_step_whole(cfg, dev, opt, b1, b2, p0, gs, n_rows: int, witness=None) -> dict:
    """Rank 0's part of ``--first-step``: the whole model at the split's
    first weights ``p0`` (whole, on the host; emptied here once on the
    device) and its gradients ``gs``.  ``n_rows``: the data ranks of the
    unsplit launch at this world, whose rows alone give the split-free
    second rounding of the bf16 gradient (each rank's rows, then their
    mean, as ``--model-axis 1`` computes it).  ``witness``: the float64
    run (``_start_f64``), each gradient's distance from it reported beside."""
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
    tokens, rows = b1["tokens"], None
    for i in range(n_rows):
        part = {"tokens": tokens[i * len(tokens) // n_rows:(i + 1) * len(tokens) // n_rows]}
        g = _grads(one, params, part, torch.bfloat16)
        rows = g if rows is None else [a.add_(b) for a, b in zip(rows, g)]
        del g
    grows = [(g / n_rows).cpu() for g in rows]
    del rows
    with torch.no_grad():
        loss1 = float(one.loss_fn(params, b1))
    stepf = torch.tensor(1.0, device=dev)
    p0d = [p.to(dev) for p in p0]
    p0.clear()

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

    losses = {"rows_bf16": loss2(updates(grows))}  # its updates freed before the others
    d16, ds = updates(g16), updates(gs)
    losses.update({"whole_bf16": loss2(d16), "split_bf16": loss2(ds)})
    d32 = updates(g32)
    losses["whole_fp32"] = loss2(d32)
    table = []
    for name, a, b, c, r, u, w in zip(names, gs, g16, g32, grows, ds, d16):
        a, b, c, r = (t.to(dev, torch.float64) for t in (a, b, c, r))
        nc, nb = float(c.norm()), float(b.norm())
        table.append({
            "leaf": name, "kind": _kind(name), "size": a.numel(), "fp32_norm": nc,
            "split_off_fp32": float((a - c).norm()) / max(nc, 1e-30),
            "whole_off_fp32": float((b - c).norm()) / max(nc, 1e-30),
            "rows_off_fp32": float((r - c).norm()) / max(nc, 1e-30),
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
    del d16, ds, d32
    witnessed = None
    if witness is not None:  # each gradient against float64, leaf by leaf
        proc, base = witness
        if proc.wait() == 0:
            got = torch.load(base + "_f64.pt", mmap=True)
            witnessed = {"loss": got["loss"]}
            for row, f, a, b, c, r in zip(table, got["grads"], gs, g16, g32, grows):
                f = f.to(dev, torch.float64)
                nf = float(f.norm())
                row["f64_norm"] = nf
                for key, t in (("split", a), ("whole", b), ("fp32", c), ("rows", r)):
                    row[f"{key}_off_f64"] = (float((t.to(dev, torch.float64) - f).norm())
                                             / max(nf, 1e-30))
        for path in (base + "_f64_in.pt", base + "_f64.pt"):
            if os.path.exists(path):
                os.remove(path)
    g32_n = math.sqrt(sum(row["fp32_norm"] ** 2 for row in table))

    def off(key, rows=table):  # over ``rows``, of their fp32 norm
        return (math.sqrt(sum((row[key] * row["fp32_norm"]) ** 2 for row in rows))
                / max(math.sqrt(sum(row["fp32_norm"] ** 2 for row in rows)), 1e-30))

    def off64(key, rows):  # over ``rows``, of their float64 norm
        return (math.sqrt(sum((row[key] * row["f64_norm"]) ** 2 for row in rows))
                / max(math.sqrt(sum(row["f64_norm"] ** 2 for row in rows)), 1e-30))

    # the same-weights factor (phases 58 and 60's bar: at most 2), kind by kind,
    # against fp32 and, where the witness ran, against float64
    factor = {}
    for k in kinds + ["all"]:
        rows_k = table if k == "all" else [row for row in table if row["kind"] == k]
        whole_k = off("whole_off_fp32", rows_k)
        factor[k] = {"split": off("split_off_fp32", rows_k) / max(whole_k, 1e-30),
                     "rows": off("rows_off_fp32", rows_k) / max(whole_k, 1e-30),
                     "whole_off_fp32": whole_k}
        if witnessed is not None:
            w64 = off64("whole_off_f64", rows_k)
            factor[k].update({"split_f64": off64("split_off_f64", rows_k) / max(w64, 1e-30),
                              "rows_f64": off64("rows_off_f64", rows_k) / max(w64, 1e-30),
                              "whole_off_f64": w64, "fp32_off_f64": off64("fp32_off_f64",
                                                                          rows_k)})
    if witnessed is not None:
        witnessed["norm"] = math.sqrt(sum(row["f64_norm"] ** 2 for row in table))
    return {"same_init": same_init, "loss1_whole_bf16": loss1, "loss2": losses,
            "clip": {k: clip_of(g)[1] for k, g in (("split", gs), ("whole_bf16", g16),
                                                     ("whole_fp32", g32), ("rows_bf16", grows))},
            "split_off_fp32": off("split_off_fp32"), "whole_off_fp32": off("whole_off_fp32"),
            "rows_off_fp32": off("rows_off_fp32"), "fp32_norm": g32_n, "n_rows": n_rows,
            "factor": factor, "swap": swap, "swap_fp32": swap32, "f64": witnessed,
            "table": table}


def _first_step(nproc: int, out: str, layers: int, rest: list[str], card: str) -> int:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", __file__, "--first-rank-main", out, str(layers), *rest]
    t = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
    wall = time.perf_counter() - t
    assert run.returncode == 0, run.stderr[-4000:]
    res = json.load(open(out))
    table = res.pop("table")
    print(f"[first-step] {' '.join(rest)} on a (1, {nproc}) mesh, tokens {res['tokens']}, the "
          f"stream at a block's entry {res['stream']} (its sequence split: "
          f"{res['stream_split']}), {wall:.1f} s wall; the split's losses through "
          f"make_train_step {res['split_losses']}; the whole model's step-1 bf16 loss "
          f"{res['loss1_whole_bf16']!r}, the same first weights: {res['same_init']} [{card}]")
    print(f"[first-step] first gradients against fp32 over the whole model: the split's bf16 "
          f"{res['split_off_fp32']:.4g}, the whole model's {res['whole_off_fp32']:.4g}, the "
          f"whole model's with each of {res['n_rows']} data ranks' rows alone (the split-free "
          f"second rounding) {res['rows_off_fp32']:.4g} of the fp32 norm; global norms "
          f"{res['clip']} [{card}]")
    l2 = res["loss2"]
    print(f"[first-step] the second batch's bf16 loss after the first AdamW update from each "
          f"gradient: {l2}; against the whole model's bf16: the split "
          f"{abs(l2['split_bf16'] - l2['whole_bf16']) / abs(l2['whole_bf16']):.4g}, the rows "
          f"alone {abs(l2['rows_bf16'] - l2['whole_bf16']) / abs(l2['whole_bf16']):.4g}, fp32 "
          f"{abs(l2['whole_fp32'] - l2['whole_bf16']) / abs(l2['whole_bf16']):.4g} (the "
          f"launcher's bar {LOSS_TOL}) [{card}]")
    f = res["factor"]
    print(f"[first-step] the same-weights factor (off fp32 over the whole model's bf16 off "
          f"fp32; bar {FACTOR}): the split {f['all']['split']:.4f}, the rows alone "
          f"{f['all']['rows']:.4f}; kinds where the split exceeds {FACTOR}: "
          f"{[k for k, v in f.items() if v['split'] > FACTOR]}, the rows alone: "
          f"{[k for k, v in f.items() if v['rows'] > FACTOR]} [{card}]")
    w = res["f64"]
    if w is not None:
        print(f"[first-step] against the float64 witness (the whole model on the CPU, loss "
              f"{w['loss']!r}, gradient norm {w['norm']:.6g}): off it, of its norm, fp32 "
              f"{f['all']['fp32_off_f64']:.4g}, the whole model's bf16 "
              f"{f['all']['whole_off_f64']:.4g}; the factor over the whole model's bf16 (bar "
              f"{FACTOR}): the split {f['all']['split_f64']:.4f}, the rows alone "
              f"{f['all']['rows_f64']:.4f}; kinds where the split exceeds {FACTOR}: "
              f"{[k for k, v in f.items() if v['split_f64'] > FACTOR]}, the rows alone: "
              f"{[k for k, v in f.items() if v['rows_f64'] > FACTOR]} [{card}]")
    else:
        print(f"[first-step] no float64 witness: the disk could not hold it or it failed "
              f"[{card}]")
    kinds = sorted({row["kind"] for row in table})
    for k in kinds:
        rows = [r for r in table if r["kind"] == k]
        worst = max(rows, key=lambda r: r["split_off_whole"])
        if w is not None:
            print(f"[first-step] {k}: against float64, factor split {f[k]['split_f64']:.4f}, "
                  f"rows alone {f[k]['rows_f64']:.4f} (whole bf16 off float64 "
                  f"{f[k]['whole_off_f64']:.4g}, fp32 {f[k]['fp32_off_f64']:.4g})")
        print(f"[first-step] {k}: {len(rows)} leaves; factor split {f[k]['split']:.4f}, rows "
              f"alone {f[k]['rows']:.4f} (whole off fp32 {f[k]['whole_off_fp32']:.4g}); split "
              f"off fp32 <= {max(r['split_off_fp32'] for r in rows):.3g}, whole off fp32 <= "
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


def _torchrun(nproc: int, dtype: str, layers: int, argv: list[str], out: str,
              witness: bool = False) -> tuple[list[dict] | None, float, str]:
    """One ``torchrun`` of the launcher, its ranks' files under ``out``:
    (each rank's record, or None where the run failed; wall seconds; the
    failure's last line)."""
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", __file__, "--rank-main", out, dtype, str(layers),
           str(int(witness)), *argv]
    t = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=3000)
    wall = time.perf_counter() - t
    sys.stdout.write(run.stdout)
    if run.returncode != 0:
        err = [ln for ln in run.stderr.splitlines() if "Error" in ln] or run.stderr.splitlines()
        sys.stdout.write(run.stderr[-3000:])
        return None, wall, err[-1] if err else f"exit {run.returncode}"
    return [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(nproc)], wall, ""


def _rel(got: list[dict], want: list[dict]) -> list[float]:
    """Each step's relative distance of rank 0's losses."""
    return [abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], want[0]["losses"])]


def _fp32_check(split_dir: str, whole_dir: str, split: list[dict], whole: list[dict],
                rest: list[str], layers: int) -> dict:
    """``tools/tensor_parallel.py``'s bars on the first step through the
    launcher: the loss within its ``LOSS_TOL`` relative, every gradient
    (the data group's mean, put together whole) within ``GRAD_TOL`` of its
    leaf's largest entry."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import build_model

    from tensor_parallel import GRAD_TOL, LOSS_TOL as FP32_LOSS_TOL, _paths, _rel_worst

    with FakeTensorMode():
        names = _paths(build_model(_cfg_of(rest, layers), "cpu").init_params(0))
    got = torch.load(os.path.join(split_dir, "grads.pt"), mmap=True)
    want = torch.load(os.path.join(whole_dir, "grads.pt"), mmap=True)
    loss = abs(split[0]["losses"][0] - whole[0]["losses"][0]) / abs(whole[0]["losses"][0])
    worst, leaf = _rel_worst(got, want, names)
    out = {"loss_rel": loss, "grad_worst": worst, "grad_leaf": leaf,
           "ok": loss <= FP32_LOSS_TOL and worst <= GRAD_TOL, "bars": [FP32_LOSS_TOL, GRAD_TOL]}
    witness = os.path.join(whole_dir, "witness_f64.pt")
    if os.path.exists(witness):  # each run's worst leaf against float64, as tensor_parallel's
        f64 = torch.load(witness, mmap=True)
        out["f64"] = {"loss": f64["loss"], "split": _rel_worst(got, f64["grads"], names),
                      "whole": _rel_worst(want, f64["grads"], names)}
        out["f64"]["ok"] = out["f64"]["split"][0] <= out["f64"]["whole"][0] + GRAD_TOL
    return out


def _wait_witness(run_dir: str, timeout: float = 1800.0) -> str:
    """Wait for the unsplit launch's float64 witness (``f64_first_step``,
    started by its rank 0); its state."""
    base = os.path.join(run_dir, "witness_f64.pt")
    t = time.perf_counter()
    while time.perf_counter() - t < timeout:
        if os.path.exists(base):
            return "done"
        if os.path.exists(base + ".err"):
            return open(base + ".err").read()
        if not os.path.exists(os.path.join(run_dir, "witness_f64_in.pt")):
            return "not started (disk)"
        time.sleep(2)
    return "timed out"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--rank-main":
        rank_main(argv[1], argv[2], int(argv[3]), argv[5:], bool(int(argv[4])))
        return 0
    if argv and argv[0] == "--first-rank-main":
        first_rank_main(argv[1], int(argv[2]), argv[3:])
        return 0
    if argv and argv[0] == "--f64-first-step":
        f64_first_step(argv[1], argv[2], argv[3:])
        return 0
    ap = argparse.ArgumentParser(prog="tools/launcher_split.py")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--model-axis", type=int, default=4)
    ap.add_argument("--witness-world", type=int, default=0,
                    help="also run --model-axis 1 at this world, and hold it to the "
                         "--nproc run the same way (what rounding alone moves)")
    ap.add_argument("--fp32", action="store_true",
                    help="both launches in fp32; the first step held to "
                         "tools/tensor_parallel.py's bars")
    ap.add_argument("--layers", type=int, default=0,
                    help="the configuration cut to this depth (0: its own)")
    ap.add_argument("--split-only", action="store_true",
                    help="the --model-axis N launch alone (where --model-axis 1 cannot fit "
                         "one card); records it, checks nothing")
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
        return _first_step(args.nproc, os.path.abspath(args.out), args.layers, rest, card)
    dtype = "fp32" if args.fp32 else "bf16"
    tmp = tempfile.mkdtemp(prefix="launcher_split_")
    try:
        runs = {}
        # in fp32 the unsplit launch first: its rank 0 starts the float64 witness
        axes = ((args.model_axis,) if args.split_only else
                (1, args.model_axis) if args.fp32 else (args.model_axis, 1))
        for axis in axes:
            got, wall, err = _torchrun(args.nproc, dtype, args.layers,
                                       rest + ["--mesh", "host", "--model-axis", str(axis)],
                                       os.path.join(tmp, str(axis)), args.fp32 and axis == 1)
            runs[axis] = {"ranks": got, "wall_s": wall, "error": err}
            if got is None:
                print(f"[launcher] {' '.join(rest)} --model-axis {axis} on {args.nproc} ranks "
                      f"({dtype}) failed after {wall:.1f} s: {err} [{card}]", flush=True)
                continue
            print(f"[launcher] {' '.join(rest)} --model-axis {axis} on {args.nproc} ranks, "
                  f"{dtype}, depth {got[0]['layers']}: losses {got[0]['losses']}; the stream at "
                  f"a block's entry {got[0]['stream']}; {wall:.1f} s wall "
                  f"({[round(r['seconds'], 1) for r in got]} s in run a rank), peak "
                  f"{[round(r['peak_gib'], 2) for r in got]} GiB a rank; kernel launches rank 0 "
                  f"{ {k: v for k, v in got[0]['launches'].items() if v} } [{card}]", flush=True)
        res = {"card": card, "dtype": dtype, "layers": args.layers, "runs": runs}
        split, whole = runs[args.model_axis]["ranks"], runs.get(1, {}).get("ranks")
        if args.split_only or split is None or whole is None:
            res["ok"] = None if args.split_only and split is not None else False
            print("RESULT " + json.dumps(res), flush=True)
            return 0 if res["ok"] is None else 1
        same = all(r["losses"] == split[0]["losses"] for r in split)
        rel = _rel(split, whole)
        ok = same and len(rel) == len(whole[0]["losses"]) and max(rel) <= LOSS_TOL
        print(f"[launcher] --model-axis {args.model_axis} against 1, step for step ({dtype}): "
              f"relative {[f'{x:.3g}' for x in rel]} (tol {LOSS_TOL}); every rank's losses the "
              f"same: {same}; ok {ok} [{card}]", flush=True)
        res.update({"rel": rel, "ok": ok})
        if args.fp32:
            t = time.perf_counter()
            state = _wait_witness(os.path.join(tmp, "1"))
            chk = res["fp32_check"] = _fp32_check(os.path.join(tmp, str(args.model_axis)),
                                                  os.path.join(tmp, "1"), split, whole, rest,
                                                  args.layers)
            print(f"[launcher] fp32 first step, --model-axis {args.model_axis} against 1: loss "
                  f"{chk['loss_rel']:.3g} relative, gradients {chk['grad_worst']:.3g} of the "
                  f"leaf's largest entry at worst ({chk['grad_leaf']}); bars {chk['bars']}; ok "
                  f"{chk['ok']} (decides the exit code) [{card}]", flush=True)
            w = chk.get("f64")
            print(f"[launcher] the float64 witness ({state}, waited {time.perf_counter() - t:.1f} s "
                  f"after both launches)"
                  + (f": loss {w['loss']!r}; worst leaf off it, of the leaf's largest entry: "
                     f"--model-axis {args.model_axis} {w['split'][0]:.3g} ({w['split'][1]}), "
                     f"--model-axis 1 {w['whole'][0]:.3g} ({w['whole'][1]}); the split within "
                     f"the unsplit run's error plus {GRAD_TOL}: {w['ok']}" if w else "")
                  + f" [{card}]", flush=True)
            ok = chk["ok"]
        if args.witness_world:
            got, wall, _ = _torchrun(args.witness_world, dtype, args.layers,
                                     rest + ["--mesh", "host", "--model-axis", "1"],
                                     os.path.join(tmp, "witness"))
            res["witness"] = {"ranks": got, "wall_s": wall, "rel": _rel(whole, got)}
            print(f"[launcher] witness: --model-axis 1 at world {args.witness_world}: losses "
                  f"{got[0]['losses']}; {wall:.1f} s wall, peak "
                  f"{[round(r['peak_gib'], 2) for r in got]} GiB a rank; the world-{args.nproc} "
                  f"unsplit run against it, step for step: relative "
                  f"{[f'{x:.3g}' for x in res['witness']['rel']]} [{card}]", flush=True)
        print("RESULT " + json.dumps(res), flush=True)
        return 0 if ok else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
