"""How far rounding alone moves the recurrent families' results on a card:
the witnesses that the checks of ``tools/tensor_parallel.py --runs
rwkv6,zamba2`` and of ``chip_smoke.py``'s phase 60 are read against.

  PYTHONPATH=src python tools/recurrent_precision.py [--parts kernels,fp32,bf16,seeds]
  PYTHONPATH=src python tools/recurrent_precision.py --device cpu --reduced

``--parts`` (every one by default):

* ``kernels``: K7 (``wkv6``) with K7b under its gradient at rwkv6-3b's 40
  heads and a rank's 10, the SSD (``mamba2.ssd``, plain torch, at
  zamba2-2.7b's 80 heads of 64) and a dense product the shape of
  ``in_proj``, each on [4, 256] rows at once against each row alone
  (B = 1): the largest difference of every output and of every gradient a
  row owns (0: the row's result does not depend on the batch); the
  gradients summed over the rows (K7b's ``du``, the product's weight) are
  shown beside.
* ``fp32``: rwkv6-3b cut to depth 2 and zamba2-2.7b cut to depth 6 at
  full width, the four-card check's weights (seed 0) and [4, 256] batch
  (seed 1): the whole model's fp32 gradients (TF32 off) with the four
  rows at once (the rows a rank of a (1, 4) mesh holds) and averaged over
  each row alone (``--mesh host`` at world 4), on the card, against the
  same weights in float64 on the CPU (a second process in which every fp32
  of the model's code reads as float64), and the split's on (2, 2) and
  (1, 4) as the check runs it (four ranks over gloo on the one card): each
  leaf's largest error over its largest entry, the metric of the four-card
  check.
* ``bf16``: the same two models at phase 60's [2, 512] batch (seed 6): the
  first step's bf16 gradients of the whole model, of the whole model with
  each row alone (a second rounding of the same gradient) and of phase
  60's (1, 2) split (two ranks over gloo on the one card), each against
  the whole model's fp32 gradient at the same weights: the global norms,
  the distances, and the leaves where the split lies furthest beyond the
  whole model.
* ``seeds``: phases 58 and 60's same-weights factor witnessed over weight
  and batch seeds 0-3 (``SEEDS``) of phase 60's two configurations at its
  [2, 512] shape, under its (1, 2) split (sequence parallelism: the stream
  split two ways between blocks; two ranks over gloo on the one card): each
  seed's split bf16 distance from the whole model's fp32 gradient over the
  whole model's own, and, where it exceeds 1.5, that ratio for each leaf.

Prints one ``RESULT`` JSON line and, before it, the card's name and power
limit.  Measures, asserts nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tensor_parallel import (  # noqa: E402  (the sibling tool's helpers)
    _cut,
    _grads as tp_grads,
    _loss_and_grads,
    _paths,
    _tokens,
    _tree_norm,
)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import gather_leaf, spec_leaves  # noqa: E402
from repro_torch.models import build_model, mamba2  # noqa: E402
from repro_torch.train.optimizer import leaves, map_tree  # noqa: E402

NAMES = ("rwkv6-3b", "zamba2-2.7b")
SPLIT_WORLD, SPLIT_MESHES = 4, ((2, 2), (1, 4))


def _say(*a) -> None:
    print(*a, flush=True)


def _cfg(name: str, reduced: bool):
    cfg = get_config(name)
    return _cut(cfg.reduced() if reduced else cfg, 2)


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def _rows_vs_batch(fn, inputs: list[torch.Tensor], summed: tuple[int, ...] = ()) -> dict:
    """``fn(*inputs) -> outputs`` on every row at once and on each row
    alone, with the gradient of a random cotangent: the largest difference
    of the outputs and of each input's gradient (``summed``: the inputs
    whose leading dim is not the batch, their gradients summed over the
    rows)."""
    gen = torch.Generator(device=inputs[0].device).manual_seed(3)

    def run(xs):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        outs = fn(*xs)
        cots = [torch.randn(o.shape, generator=gen, device=o.device, dtype=o.dtype)
                for o in outs]
        return outs, cots, xs

    outs, cots, xs = run(inputs)
    torch.autograd.backward(outs, cots)
    b = inputs[0].shape[0]
    got = {"out": 0.0, "grad": 0.0, "summed_grad": 0.0}
    sums = {i: torch.zeros_like(inputs[i]) for i in summed}
    for row in range(b):
        one = [x if i in summed else x[row:row + 1] for i, x in enumerate(inputs)]
        xr = [x.detach().clone().requires_grad_(True) for x in one]
        o = fn(*xr)
        torch.autograd.backward(o, [c[row:row + 1] for c in cots])
        got["out"] = max(got["out"], *(_diff(a[row:row + 1], c) for a, c in zip(outs, o)))
        for i, (x, x1) in enumerate(zip(xs, xr)):
            if i in summed:
                sums[i] += x1.grad
            else:
                got["grad"] = max(got["grad"], _diff(x.grad[row:row + 1], x1.grad))
    for i in summed:
        got["summed_grad"] = max(got["summed_grad"], _diff(xs[i].grad, sums[i]) / max(
            float(xs[i].grad.abs().max()), 1e-30))
    return got


def kernels(dev, reduced: bool) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    rw, zb = _cfg("rwkv6-3b", reduced), _cfg("zamba2-2.7b", reduced)
    b, l = (4, 32) if reduced else (4, 256)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for h in (rw.n_heads, rw.n_heads // 4):
        hd = rw.hd
        w = torch.exp(-torch.exp(randn(b, l, h, hd, scale=0.5) - 2.0))
        got = _rows_vs_batch(lambda r, k, v, w, u: wkv6(r, k, v, w, u),
                             [randn(b, l, h, hd), randn(b, l, h, hd), randn(b, l, h, hd), w,
                              randn(h, hd, scale=0.1)], summed=(4,))
        out[f"wkv6_h{h}"] = got
        _say(f"[kernels] K7/K7b [{b}, {l}, {h}, {hd}] fp32: rows at once vs each alone, outputs "
             f"{got['out']:.3g}, gradients {got['grad']:.3g} apart at most; du (summed over "
             f"the rows) {got['summed_grad']:.3g} of its largest entry")
    h, p, s = zb.ssm_heads, zb.d_inner // zb.ssm_heads, zb.ssm_state
    dt = torch.nn.functional.softplus(randn(b, l, h) - 2.0)

    def ssd(xh, dt, log_decay, bm, cm):
        return mamba2.ssd(xh, dt, log_decay, bm, cm, torch.zeros(
            (xh.shape[0], h, p, s), device=dev))

    got = _rows_vs_batch(ssd, [randn(b, l, h, p), dt, -dt * 0.5, randn(b, l, s), randn(b, l, s)])
    out["ssd"] = got
    _say(f"[kernels] SSD [{b}, {l}, {h}, {p}] state {s} fp32: outputs {got['out']:.3g}, "
         f"gradients {got['grad']:.3g} apart at most")
    d, n = zb.d_model, 2 * zb.d_inner + 2 * s + h
    got = _rows_vs_batch(lambda x, wt: (x @ wt,),
                         [randn(b, l, d), randn(d, n, scale=d ** -0.5)], summed=(1,))
    out["dense"] = got
    _say(f"[kernels] dense [{b}, {l}, {d}] @ [{d}, {n}] fp32: outputs {got['out']:.3g}, the "
         f"input's gradient {got['grad']:.3g} apart at most; the weight's (summed over the "
         f"rows) {got['summed_grad']:.3g} of its largest entry")
    return out


def _names(cfg) -> list[str]:
    with FakeTensorMode():
        return _paths(build_model(cfg, "cpu").init_params(0))


def _grads(cfg, dev, tokens, dtype, seed: int = 0) -> tuple[float, list[torch.Tensor]]:
    model = build_model(cfg, dev)
    params = model.init_params(seed)
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.loss_fn(params, {"tokens": tokens}, dtype=dtype)
    loss.backward()
    return float(loss), [p.grad.detach() for p in leaves(params)]


def f64_worker(name: str, reduced: bool, dev: str, out: str, layers: int | None = None,
               ready: str | None = None) -> None:
    """The four-card check's gradients in float64 on the CPU: ``name`` cut
    to ``layers`` (default: as ``_cfg`` cuts it), the weights drawn in fp32
    on ``dev`` (each device's generator draws its own numbers; ``ready`` is
    written once they have left the device), then the model's fp32 read as
    float64 (``Tensor.float``, ``torch.float32``) for this process."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    cfg = _cfg(name, reduced)
    if layers is not None:
        base = get_config(name)
        cfg = dataclasses.replace(base.reduced() if reduced else base, n_layers=layers)
    model = build_model(cfg, "cpu")
    params = map_tree(lambda p: p.cpu(), build_model(cfg, dev).init_params(0))
    torch.cuda.empty_cache()
    if ready:
        Path(ready).write_text("drawn")
    tokens = _tokens(cfg, (4, 32) if reduced else (4, 256), 1, "cpu")
    import repro_torch.kernels.wkv6 as k7
    single = torch.float32  # the saved gradients' dtype, before fp32 reads as float64
    torch.Tensor.float = torch.Tensor.double
    torch.float32 = torch.float64
    k7.INPUT_DTYPES = k7.INPUT_DTYPES + (torch.float64,)
    for p in leaves(params):
        p.data = p.data.double()
        p.requires_grad_(True)
    loss = model.loss_fn(params, {"tokens": tokens}, dtype=torch.float64)
    loss.backward()
    torch.save({"loss": float(loss), "grads": [p.grad.to(single) for p in leaves(params)]}, out)


def _worst(got: list[torch.Tensor], want: list[torch.Tensor], names: list[str], n: int = 3):
    errs = sorted(((_diff(a, b.to(a.device)) / max(float(b.abs().max()), 1e-30), name)
                   for a, b, name in zip(got, want, names)), reverse=True)
    return [[round(e, 9), name] for e, name in errs[:n]]


def split_worker(rank: int, reduced: bool, dev: str, out: str) -> None:
    """Rank ``rank`` of four over gloo on one device: the four-card check's
    split runs (``tensor_parallel._loss_and_grads`` on (2, 2) and (1, 4)),
    each gradient put together whole; rank 0 saves them."""
    dist.init_process_group("gloo", init_method=f"file://{out}.store", rank=rank,
                            world_size=SPLIT_WORLD)
    dev = torch.device(dev)
    got = {}
    for name in NAMES:
        cfg = _cfg(name, reduced)
        tokens = _tokens(cfg, (4, 32) if reduced else (4, 256), 1, dev)
        for m in SPLIT_MESHES:
            mesh = make_mesh(m, ("data", "model"), dev)
            _, grads, tp = _loss_and_grads(cfg, mesh, tokens, dev)
            got[(name, m)] = [gather_leaf(g, spec, mesh)
                              for g, spec in zip(grads, spec_leaves(tp.specs))]
    if rank == 0:
        torch.save(got, out)
    dist.barrier()
    dist.destroy_process_group()


def _start(argv: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__] + argv, env=dict(os.environ))


def fp32(dev, reduced: bool, tmp: str) -> dict:
    flag = ["--reduced"] * reduced + ["--device", str(dev)]
    workers = {}
    for name in NAMES:  # the float64 witnesses, on the CPU, while the card works
        path = os.path.join(tmp, f"{name}.pt")
        workers[name] = (path, _start(["--f64-worker", name, path] + flag))
    split_path = os.path.join(tmp, "split.pt")
    splits = [_start(["--split-worker", str(r), split_path] + flag) for r in range(SPLIT_WORLD)]
    out, split = {}, None
    for name in NAMES:
        cfg = _cfg(name, reduced)
        tokens = _tokens(cfg, (4, 32) if reduced else (4, 256), 1, dev)
        loss, batch = _grads(cfg, dev, tokens, torch.float32)
        rows = None
        for i in range(tokens.shape[0]):
            _, g = _grads(cfg, dev, tokens[i:i + 1], torch.float32)
            rows = g if rows is None else [a + b for a, b in zip(rows, g)]
        rows = [g / tokens.shape[0] for g in rows]
        path, proc = workers[name]
        assert proc.wait() == 0, f"the float64 run of {name} failed"
        want = torch.load(path)
        os.remove(path)
        if split is None:
            assert all(p.wait() == 0 for p in splits), "the split runs failed"
            split = torch.load(split_path)
        batch, rows = [g.cpu() for g in batch], [g.cpu() for g in rows]
        names = _names(cfg)
        r = out[name] = {
            "loss_fp32": loss, "loss_f64": want["loss"],
            "rows_at_once_vs_f64": _worst(batch, want["grads"], names),
            "each_row_alone_vs_f64": _worst(rows, want["grads"], names),
            "at_once_vs_alone": _worst(batch, rows, names),
        }
        for m in SPLIT_MESHES:
            key = f"{m[0]}x{m[1]}"
            r[f"split_{key}_vs_f64"] = _worst(split[(name, m)], want["grads"], names)
            r[f"split_{key}_vs_alone"] = _worst(split[(name, m)], rows, names)
        _say(f"[fp32] {name} depth {cfg.n_layers}, [{tokens.shape[0]}, {tokens.shape[1]}]: "
             f"loss fp32 {loss!r} vs float64 {want['loss']!r}; each leaf's largest gradient "
             f"error over its largest entry, the worst three: the four rows at once against "
             f"float64 {r['rows_at_once_vs_f64']}, each row alone (--mesh host) against "
             f"float64 {r['each_row_alone_vs_f64']}, the two against each other "
             f"{r['at_once_vs_alone']}; the split over gloo on this device: (2, 2) against "
             f"float64 {r['split_2x2_vs_f64']}, against each row alone "
             f"{r['split_2x2_vs_alone']}; (1, 4) against float64 {r['split_1x4_vs_f64']}, "
             f"against each row alone {r['split_1x4_vs_alone']}")
    return out


def bf16_split_worker(rank: int, reduced: bool, dev: str, out: str) -> None:
    """Rank ``rank`` of two over gloo on one device: phase 60's split on a
    (1, 2) mesh, the first step's bf16 gradients put together whole; rank
    0 saves them."""
    dist.init_process_group("gloo", init_method=f"file://{out}.store", rank=rank,
                            world_size=2)
    dev = torch.device(dev)
    mesh, got = make_mesh((1, 2), ("data", "model"), dev), {}
    for name in NAMES:
        cfg = _cfg(name, reduced)
        model = build_model(cfg, dev, tp=mesh)
        params = model.init_params(0)
        for p in leaves(params):
            p.requires_grad_(True)
        grads = tp_grads(model, params, {"tokens": _bf16_tokens(cfg, reduced, dev)},
                         torch.bfloat16)
        got[name] = [gather_leaf(g, spec, mesh).cpu()
                     for g, spec in zip(grads, spec_leaves(model.tp.specs))]
    if rank == 0:
        torch.save(got, out)
    dist.barrier()
    dist.destroy_process_group()


def _bf16_tokens(cfg, reduced: bool, dev):
    return _tokens(cfg, (2, 64) if reduced else (2, 512), 6, dev)


def bf16(dev, reduced: bool, tmp: str) -> dict:
    split_path = os.path.join(tmp, "bf16_split.pt")
    flag = ["--reduced"] * reduced + ["--device", str(dev)]
    splits = [_start(["--bf16-split-worker", str(r), split_path] + flag) for r in range(2)]
    out, split = {}, None
    for name in NAMES:
        cfg = _cfg(name, reduced)
        tokens = _bf16_tokens(cfg, reduced, dev)
        l16, g16 = _grads(cfg, dev, tokens, torch.bfloat16)
        l32, g32 = _grads(cfg, dev, tokens, torch.float32)
        rows = None  # a second rounding of the same gradient: each row alone
        for i in range(tokens.shape[0]):
            _, g = _grads(cfg, dev, tokens[i:i + 1], torch.bfloat16)
            rows = g if rows is None else [a.double() + b.double() for a, b in zip(rows, g)]
        rows = [g / tokens.shape[0] for g in rows]
        if split is None:
            assert all(p.wait() == 0 for p in splits), "the split runs failed"
            split = torch.load(split_path)
        names = _names(cfg)
        g16, g32, rows = ([g.cpu().double() for g in gs] for gs in (g16, g32, rows))
        gs = [g.double() for g in split[name]]
        n16, n32 = _tree_norm(g16), _tree_norm(g32)

        def off(got):
            return _tree_norm([a - b for a, b in zip(got, g32)])

        e16, erows, esplit = off(g16), off(rows), off(gs)
        excess = sorted(((float((s_ - w).norm() - (a - w).norm()), n,
                          float((a - w).norm() / max(float(w.norm()), 1e-30)),
                          float((s_ - w).norm() / max(float(w.norm()), 1e-30)))
                         for a, s_, w, n in zip(g16, gs, g32, names)), reverse=True)
        out[name] = {"loss_bf16": l16, "loss_fp32": l32, "norm_bf16": n16, "norm_fp32": n32,
                     "norm_split": _tree_norm(gs), "norm_rows": _tree_norm(rows),
                     "off_fp32": e16, "off_fp32_rows": erows, "off_fp32_split": esplit,
                     "most_excess": [[round(x, 6), n, round(a, 6), round(b, 6)]
                                     for x, n, a, b in excess[:5]]}
        r = out[name]
        _say(f"[bf16] {name} depth {cfg.n_layers}, [{tokens.shape[0]}, {tokens.shape[1]}], the "
             f"first step's gradients: loss bf16 {l16!r} vs fp32 {l32!r}; global norms bf16 "
             f"{n16!r}, fp32 {n32!r}, the rows alone in bf16 {r['norm_rows']!r}, the (1, 2) split "
             f"in bf16 {r['norm_split']!r}; distance from the fp32 gradient: the whole model "
             f"{e16:.6g} ({100 * e16 / n32:.2f} % of its norm), the rows alone {erows:.6g}, the "
             f"split {esplit:.6g}; the leaves where the split lies furthest beyond the whole "
             f"model (excess, leaf, each one's distance over the leaf's fp32 norm) "
             f"{r['most_excess']}")
    return out


SEEDS = range(4)


def _seed_tokens(cfg, reduced: bool, seed: int, dev):
    return _tokens(cfg, (2, 64) if reduced else (2, 512), seed, dev)


def seeds_split_worker(rank: int, reduced: bool, dev: str, out: str) -> None:
    """Rank ``rank`` of two over gloo on one device: phase 60's (1, 2)
    split, under sequence parallelism, at weight and batch seeds 0-3, the
    first step's bf16 gradients put together whole; rank 0 saves them."""
    dist.init_process_group("gloo", init_method=f"file://{out}.store", rank=rank,
                            world_size=2)
    dev = torch.device(dev)
    mesh, got = make_mesh((1, 2), ("data", "model"), dev), {}
    for name in NAMES:
        cfg = _cfg(name, reduced)
        model = build_model(cfg, dev, tp=mesh)
        for seed in SEEDS:
            params = model.init_params(seed)
            for p in leaves(params):
                p.requires_grad_(True)
            grads = tp_grads(model, params, {"tokens": _seed_tokens(cfg, reduced, seed, dev)},
                             torch.bfloat16)
            got[(name, seed)] = [gather_leaf(g, spec, mesh).cpu()
                                 for g, spec in zip(grads, spec_leaves(model.tp.specs))]
            del params, grads
    if rank == 0:
        torch.save(got, out)
    dist.barrier()
    dist.destroy_process_group()


def seeds(dev, reduced: bool, tmp: str) -> dict:
    """Item 34's witness of phases 58 and 60's same-weights factor: for each
    weight and batch seed 0-3 of phase 60's two configurations, the split's
    bf16 distance from the whole model's fp32 gradient over the whole
    model's own bf16 distance (the factor the check holds to 2); where it
    exceeds 1.5, the same ratio for each leaf."""
    split_path = os.path.join(tmp, "seeds_split.pt")
    flag = ["--reduced"] * reduced + ["--device", str(dev)]
    workers = [_start(["--seeds-split-worker", str(r), split_path] + flag) for r in range(2)]
    assert all(p.wait() == 0 for p in workers), "the split runs failed"
    split = torch.load(split_path)
    out = {}
    for name in NAMES:
        cfg = _cfg(name, reduced)
        names = _names(cfg)
        for seed in SEEDS:
            tokens = _seed_tokens(cfg, reduced, seed, dev)
            _, g16 = _grads(cfg, dev, tokens, torch.bfloat16, seed)
            _, g32 = _grads(cfg, dev, tokens, torch.float32, seed)
            g16, g32 = [g.cpu().double() for g in g16], [g.cpu().double() for g in g32]
            gs = [g.double() for g in split[(name, seed)]]
            e16 = _tree_norm([a - b for a, b in zip(g16, g32)])
            es = _tree_norm([a - b for a, b in zip(gs, g32)])
            r = out[f"{name}/{seed}"] = {"off_fp32_whole": e16, "off_fp32_split": es,
                                         "ratio": es / e16, "norm_fp32": _tree_norm(g32)}
            if r["ratio"] > 1.5:
                leaf = sorted(((float((s_ - w).norm() / max(float((a - w).norm()), 1e-30)), n)
                               for a, s_, w, n in zip(g16, gs, g32, names)), reverse=True)
                r["leaf_ratios"] = [[round(x, 4), n] for x, n in leaf]
            _say(f"[seeds] {name} depth {cfg.n_layers}, weights and batch seed {seed}, "
                 f"[{tokens.shape[0]}, {tokens.shape[1]}]: the first step's bf16 gradient off the "
                 f"whole model's fp32 one: the whole model {e16:.6g}, the (1, 2) split {es:.6g} "
                 f"(ratio {r['ratio']:.4f}; the check holds it to 2)"
                 + (f"; by leaf, the largest {r['leaf_ratios'][:8]}" if "leaf_ratios" in r else ""))
    worst = max(r["ratio"] for r in out.values())
    _say(f"[seeds] the largest ratio over {len(out)} runs: {worst:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/recurrent_precision.py")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--parts", default="kernels,fp32,bf16,seeds")
    ap.add_argument("--f64-worker", nargs=2, metavar=("NAME", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--layers", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ready", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--split-worker", nargs=2, metavar=("RANK", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--bf16-split-worker", nargs=2, metavar=("RANK", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--seeds-split-worker", nargs=2, metavar=("RANK", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.seeds_split_worker:
        seeds_split_worker(int(args.seeds_split_worker[0]), args.reduced, args.device,
                           args.seeds_split_worker[1])
        return 0
    if args.bf16_split_worker:
        bf16_split_worker(int(args.bf16_split_worker[0]), args.reduced, args.device,
                          args.bf16_split_worker[1])
        return 0
    if args.split_worker:
        if args.device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        split_worker(int(args.split_worker[0]), args.reduced, args.device, args.split_worker[1])
        return 0
    if args.f64_worker:
        f64_worker(args.f64_worker[0], args.reduced, args.device, args.f64_worker[1],
                   args.layers, args.ready)
        return 0
    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().split("\n")[0]
    _say(f"[card] {card}; torch {torch.__version__}")
    res, t0 = {"card": card}, time.perf_counter()
    parts = args.parts.split(",")
    if "kernels" in parts:
        res["kernels"] = kernels(dev, args.reduced)
    if "fp32" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            res["fp32"] = fp32(dev, args.reduced, tmp)
    if "bf16" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            res["bf16"] = bf16(dev, args.reduced, tmp)
    if "seeds" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            res["seeds"] = seeds(dev, args.reduced, tmp)
    res["seconds"] = time.perf_counter() - t0
    _say(f"[card] {card}")
    _say("RESULT " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
