"""Tensor parallelism over "model" on cards: a model split over a (data,
model) mesh (``repro_torch.models.tensor_parallel``) held against data
parallelism alone, and timed.

  PYTHONPATH=src torchrun --standalone --nproc_per_node 4 tools/tensor_parallel.py
  OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
      tools/tensor_parallel.py --device cpu --reduced

Four ranks (NCCL, a card each; gloo on the CPU, where ``--reduced`` cuts
every configuration and shape):

1. olmo-1b at full width and depth on (2, 2) and (1, 4), granite-3-8b on
   (1, 4).  Check, fp32 with TF32 off, a [4, 256] batch: the loss (the
   data groups' mean) against the launcher's ``--mesh host`` at world 4
   (every rank the whole model, a row each) to 1e-5 relative, and every
   gradient (averaged over the data group) to 1e-4 of its leaf's largest
   entry.  Time: bf16 steps of ``make_train_step`` with the launcher's
   data-group mean on a global [8, 2048] batch, two to warm up, then the
   median ms of five, tokens a second, each rank's peak memory, and the
   share of a step the compute stream waits on model-axis collectives
   (CUDA events around each ``all_reduce``, ``broadcast``,
   ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` over the model
   group; their buffers' bytes by kind), with ``--mesh host``'s step
   beside them where the whole model and its AdamW state fit a card
   (olmo-1b; granite-3-8b's 8.2e9
   parameters take 131 GB of fp32 state a card, so its host step does
   not run).  The bytes a step's leaf gathers move (leaves the rules split
   otherwise than their use: granite's tied table split on d) are counted.
2. command-r-plus-104b at model = 4.  At depth 2 in fp32: prefill logits
   of [2, 64] prompts against the same weights on one card (rank 0's) to
   1e-4 relative, and 8 greedy tokens equal.  At full width and depth in
   bf16 (104e9 parameters, 52 GB a card): the GiB a rank holds at the
   build's peak, the prefill of [4, 2048] prompts (ms, the KV cache's
   GiB), and the median decode-step ms of the 7 steps after a prefill of
   16-token prompts.
3. ``--runs rwkv6,zamba2``, the recurrent families (``models.rwkv6``,
   ``models.mamba2`` under ``tp``): rwkv6-3b at depth 2 and zamba2-2.7b at
   depth 6 (one group: six Mamba2 layers and the shared block; no shallower
   cut keeps its pattern) checked in fp32 as olmo-1b is, on (2, 2) and (1,
   4); bf16 steps at full depth (32 and 54 layers) on (1, 4) and on
   ``--mesh host`` on a global [8, 2048] batch, timed as above, with K7/K7b
   or K6/K6b launches and the bytes all-reduced over the model group a
   step; served at model = 4 at the same depths in fp32 against one card
   (the logits after a [2, 64] prompt, fed token by token as
   ``greedy_generate`` does, to 1e-4 relative, and 8 greedy tokens equal).

Every split runs under sequence parallelism where the length divides the
model axis (the stream [B, S/m, d] a rank between blocks).  Beside each check stands the
unsplit model run with the split run's rows (each data group's on every
rank of it) against ``--mesh host``: how far the rows a rank sums move the
gradients with no split at all; and the float64 witness
(``Float64Witness``: the same weights in float64 on the CPU, run by
``tools/recurrent_precision.py``'s ``f64_worker`` while the cards work):
each split's and ``--mesh host``'s worst-leaf gradient error against it,
the split passing where its error is at most the host's plus
``GRAD_TOL``.  The 1e-4 check against ``--mesh host`` alone decides the
exit code.

``--smoke`` is ``chip_smoke.py``'s phase 58: two ranks on one card over
gloo (CUDA tensors), a (1, 2) mesh, olmo-1b at full width cut to depth 2,
each rank printing one ``RESULT`` line (with the stream's shape at a
block's entry, ``block_entries``); ``--smoke --recurrent`` is phase
60: rwkv6-3b at full width cut to depth 2 and zamba2-2.7b cut to depth 6
on the same mesh (the logits of the prompts from a parallel forward: K7,
or the SSD and K6, on the rank's heads; 5 greedy tokens after 8 prompt
tokens).

Every figure is printed beside the card's name and power limit.  Exits
non-zero when a check misses its tolerance.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import hashlib
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.kernels import launches, reset_launches
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.sharding import (gather_leaf, gather_tree, shard_slices, sharded_flags,
                                         spec_leaves)
from repro_torch.launch.train import _mean_over
from repro_torch.models import build_model, mamba2, moe, rwkv6, transformer
from repro_torch.serve import greedy_generate
from repro_torch.serve.engine import _argmax, scan_prefill
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train.optimizer import leaves, map_tree

LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-4
GiB = 1 << 30
ROOT = Path(__file__).resolve().parents[1]


def _say(*a) -> None:
    if dist.get_rank() == 0:
        print(*a, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / GiB if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


# the collectives over the model group, and which argument holds the whole
# buffer: an all-gather's output, a reduce-scatter's input
KINDS = {"all_reduce": 0, "broadcast": 0, "all_gather_into_tensor": 0,
         "reduce_scatter_tensor": 1}


class CollectiveClock:
    """CUDA events around every ``all_reduce``, ``broadcast``,
    ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` over one group,
    while ``on``: the time the compute stream waits on them, and the bytes
    of each one's whole buffer by kind (an all-reduce's tensor, an
    all-gather's output, a reduce-scatter's input: on a ring an all-reduce
    moves (m-1)/m of its buffer twice, the other two once).  (A wrapper of
    ``torch.distributed``'s functions, for this tool only.)"""

    def __init__(self, group, dev):
        self.group, self.dev, self.on, self.pairs = group, dev, False, []
        self.bytes = dict.fromkeys(KINDS, 0)
        self._orig = {name: getattr(dist, name) for name in KINDS}
        for name, fn in self._orig.items():
            setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(*a, group=None, **kw):
            if not (self.on and group is self.group and self.dev.type == "cuda"):
                return fn(*a, group=group, **kw)
            whole = a[KINDS[name]]
            self.bytes[name] += whole.numel() * whole.element_size()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, group=group, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        return timed

    def take_ms(self) -> tuple[float, int, int, dict]:
        """(ms, calls, bytes, bytes by kind) since the last take."""
        _sync(self.dev)
        ms = sum(s.elapsed_time(e) for s, e in self.pairs)
        kinds = {k: v for k, v in self.bytes.items() if v}
        out = ms, len(self.pairs), sum(kinds.values()), kinds
        self.pairs, self.bytes = [], dict.fromkeys(KINDS, 0)
        return out

    def close(self) -> None:
        for name, fn in self._orig.items():
            setattr(dist, name, fn)


def traced(fn, dev) -> tuple:
    """(fn's result, where one call's time went on rank 0: its host ms, the
    device's busy ms, the NCCL kernels' ms, the five costliest kernels)
    under ``torch.profiler`` (``chip_smoke._traced``); the other ranks, and
    the CPU, run ``fn`` untraced (None)."""
    if dev.type != "cuda" or dist.get_rank() != 0:
        return fn(), None
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    wall = []

    def timed():
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall.append((time.perf_counter() - t) * 1e3)
        return out

    out, us = chip_smoke._traced(timed)
    top = sorted(us.items(), key=lambda kv: -kv[1])[:5]
    return out, {"host_ms": wall[0], "busy_ms": sum(us.values()) / 1e3,
                 "nccl_ms": sum(v for k, v in us.items() if "nccl" in k.lower()) / 1e3,
                 "top_ms": {k[:80]: v / 1e3 for k, v in top}}


# each family's functions that take the stream at a block's entry
_BLOCKS = {"moe": (moe, ("_block_apply",)), "ssm": (rwkv6, ("_block_apply",)),
           "hybrid": (mamba2, ("_mamba_body", "_shared_apply"))}


@contextlib.contextmanager
def block_entries(cfg):
    """A list of the stream's shape each time one of ``cfg``'s blocks is
    entered, while inside: [B, S/m, d] on a rank whose stream is split (a
    wrapper of the family's block functions, for this tool only)."""
    mod, names = _BLOCKS.get(cfg.family, (transformer, ("_block_apply",)))
    shapes, saved = [], {}
    for name in names:
        fn = saved[name] = getattr(mod, name)
        sig = inspect.signature(fn)

        def recorded(*a, _fn=fn, _sig=sig, **kw):
            shapes.append(list(_sig.bind(*a, **kw).arguments["x"].shape))
            return _fn(*a, **kw)

        setattr(mod, name, recorded)
    try:
        yield shapes
    finally:
        for name, fn in saved.items():
            setattr(mod, name, fn)


def _tokens(cfg, shape, seed, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32)).to(dev)


def _rows(mesh, total: int) -> slice:
    n, i = mesh.size(mesh.data_axes), mesh.index(mesh.data_axes)
    return slice(i * total // n, (i + 1) * total // n)


def _mean(x: torch.Tensor, mesh) -> torch.Tensor:
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group(mesh.data_axes))
    return x / mesh.size(mesh.data_axes)


def _loss_and_grads(cfg, mesh, tokens, dev, split=True):
    """fp32 loss (data groups' mean) and this rank's gradients (data-group
    mean), on the host, with the split (None: whole leaves).  ``split``
    False: the whole model on every rank of ``mesh``, its rows as
    ``mesh`` deals them (the same batch layout, no model split)."""
    model = build_model(cfg, dev, tp=mesh if split else None)
    params = model.init_params(0)  # no AdamW moments: granite's whole model is 33 GB a copy
    for p in leaves(params):
        p.requires_grad_(True)
    loss = model.loss_fn(params, {"tokens": tokens[_rows(mesh, tokens.shape[0])]},
                         dtype=torch.float32)
    loss.backward()
    grads = _mean_over(mesh.group(mesh.data_axes))([p.grad for p in leaves(params)])
    out = float(_mean(loss, mesh)), [g.cpu() for g in grads], model.tp
    del params, grads, loss, model
    return out


def _paths(tree, prefix="") -> list[str]:
    """Each leaf's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in _paths(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, list):
        return [p for i, sub in enumerate(tree) for p in _paths(sub, f"{prefix}/{i}")]
    return [] if tree is None else [prefix]


def _worst(grads, want, tp, names, dev) -> tuple[float, str]:
    """The largest gradient error of a split run over the whole leaves
    ``want``, relative to each leaf's largest entry, and its leaf."""
    worst = (0.0, "")
    for g, w, spec, name in zip(grads, want, spec_leaves(tp.specs), names):
        block = w[shard_slices(tuple(w.shape), spec, tp.mesh)]
        err = torch.tensor([float((g - block).abs().max())], device=dev)
        dist.all_reduce(err, op=dist.ReduceOp.MAX, group=tp.group)
        worst = max(worst, (float(err) / max(float(w.abs().max()), 1e-30), name))
    return worst


class Float64Witness:
    """``tools/recurrent_precision.py``'s ``f64_worker`` started by rank 0:
    ``cfg``'s gradients on the check's batch in float64 on the CPU while the
    cards work, from the weights the cards draw (it draws them on rank 0's
    device first; ``start`` returns once they have left it).  ``grads()``:
    every rank's view of them (a memory map of one file).  Not started
    where the host has too little memory for a float64 model beside the
    ranks' fp32 copies (``fits``)."""

    def __init__(self, cfg, reduced: bool, dev):
        self.cfg, self.reduced, self.dev, self.proc, self.dir = cfg, reduced, dev, None, None
        with FakeTensorMode():
            self.n = sum(p.numel() for p in leaves(build_model(cfg, "cpu").init_params(0)))
        self.need = 20 * self.n  # float64 parameters and gradients, one fp32 copy
        self.why = ""

    def fits(self) -> bool:
        """Within half the host's available memory (the ranks hold fp32
        copies of the whole gradient beside it), its fp32 gradients' file
        within half the free disk."""
        self.dir = tempfile.mkdtemp(prefix="f64_")
        mem = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        disk = shutil.disk_usage(self.dir).free
        self.why = (f"the float64 model's {self.need / GiB:.0f} GiB against {mem / GiB:.0f} GiB "
                    f"of available memory, its {4 * self.n / GiB:.0f} GiB file against "
                    f"{disk / GiB:.0f} GiB of free disk")
        return 2 * self.need <= mem and 8 * self.n <= disk

    def start(self) -> bool:
        go = self.fits() if dist.get_rank() == 0 else False
        if go:
            ready = os.path.join(self.dir, "ready")
            self.proc = subprocess.Popen(
                [sys.executable, str(ROOT / "tools" / "recurrent_precision.py"), "--f64-worker",
                 self.cfg.name, os.path.join(self.dir, "grads.pt"), "--layers",
                 str(self.cfg.n_layers), "--ready", ready, "--device", self.dev.type]
                + ["--reduced"] * self.reduced, env=dict(os.environ))
            while not os.path.exists(ready):
                if self.proc.poll() is not None:
                    go, self.why = False, (f"the float64 worker exited {self.proc.returncode} "
                                           f"before its weights were drawn")
                    break
                time.sleep(0.5)
        flag = [go]
        dist.broadcast_object_list(flag, src=0)
        return flag[0]

    def grads(self) -> list[torch.Tensor] | None:
        """The float64 gradients (rounded to fp32), or None where the
        worker exited with an error (``why`` says so)."""
        path = [None]
        if dist.get_rank() == 0:
            rc = self.proc.wait()
            path = [os.path.join(self.dir, "grads.pt") if rc == 0 else None]
            self.why = f"the float64 worker exited {rc}"
        dist.broadcast_object_list(path, src=0)
        return torch.load(path[0], mmap=True)["grads"] if path[0] else None

    def close(self) -> None:
        dist.barrier()
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait()
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)


def _rel_worst(got, want, names) -> tuple[float, str]:
    """The largest error of ``got`` over whole leaves ``want``, relative to
    each leaf's largest entry, and its leaf."""
    return max((float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), name)
               for a, b, name in zip(got, want, names))


def check(cfg, meshes, shape, dev, reduced=False) -> dict:
    """The split runs' loss and gradients against ``--mesh host`` at this
    world (``ok`` where they hold ``LOSS_TOL`` and ``GRAD_TOL``), beside
    the unsplit model's with the split run's batch layout (each data
    group's rows on every rank of it) against the same: what the rows a
    rank sums alone move, the noise the tolerance must clear.  Beside
    them, the float64 witness (``Float64Witness``): the split's and
    ``--mesh host``'s worst-leaf errors against the same weights in
    float64, ``f64_ok`` where the split's is at most the host's plus
    ``GRAD_TOL``.  ``ok`` alone decides the tool's exit code."""
    tokens = _tokens(cfg, shape, 1, dev)
    _reset_peak(dev)
    witness = Float64Witness(cfg, reduced, dev)
    witnessed = witness.start()
    host_loss, host_grads, _ = _loss_and_grads(cfg, make_host_mesh("data", dev), tokens, dev)
    with FakeTensorMode():
        names = _paths(build_model(cfg, "cpu").init_params(0))
    f64 = witness.grads() if witnessed else None
    host_f64 = _rel_worst(host_grads, f64, names) if f64 is not None else None
    out = {}
    for m in meshes:
        mesh = make_mesh(m, ("data", "model"), dev)
        loss, grads, tp = _loss_and_grads(cfg, mesh, tokens, dev)
        _, same_grads, _ = _loss_and_grads(cfg, mesh, tokens, dev, split=False)
        host, same = _worst(grads, host_grads, tp, names, dev), _worst(grads, same_grads, tp,
                                                                        names, dev)
        layout = _rel_worst(same_grads, host_grads, names)
        del same_grads
        rel = abs(loss - host_loss) / abs(host_loss)
        key = f"{m[0]}x{m[1]}"
        out[key] = {
            "loss": loss, "host_loss": host_loss, "loss_rel": rel,
            "grad_rel_max": host[0], "worst_leaf": host[1],
            "grad_rel_max_same_layout": same[0], "worst_leaf_same_layout": same[1],
            "layout_alone_grad_rel_max": layout[0], "layout_alone_worst_leaf": layout[1],
            "ok": rel <= LOSS_TOL and host[0] <= GRAD_TOL}
        _say(f"[check] {cfg.name} {m}: fp32 loss {loss!r} vs --mesh host {host_loss!r} (rel "
             f"{rel:.3g}, tol {LOSS_TOL}); gradients {host[0]:.3g} of each leaf's largest entry "
             f"off --mesh host's at most ({host[1]}; tol {GRAD_TOL}); the unsplit model with this "
             f"mesh's rows {layout[0]:.3g} off --mesh host's ({layout[1]}), the split "
             f"{same[0]:.3g} off it ({same[1]})")
        if f64 is None:
            _say(f"[f64] {cfg.name} {m}: not run ({witness.why})")
            continue
        split_f64 = _worst(grads, f64, tp, names, dev)
        out[key].update({"f64_grad_rel_max": split_f64[0], "f64_worst_leaf": split_f64[1],
                         "host_f64_grad_rel_max": host_f64[0], "host_f64_worst_leaf": host_f64[1],
                         "f64_ok": split_f64[0] <= host_f64[0] + GRAD_TOL})
        _say(f"[f64] {cfg.name} {m}: against the same weights in float64, the split's gradients "
             f"{split_f64[0]:.3g} of each leaf's largest entry off at most ({split_f64[1]}), "
             f"--mesh host's {host_f64[0]:.3g} ({host_f64[1]}); the split within the host's "
             f"error plus {GRAD_TOL}: {out[key]['f64_ok']}")
    del f64
    witness.close()
    return out


def _gathered_bytes(tp, dtype) -> int:
    """Bytes of leaves a training step's forward puts together whole: the
    readout table where the rules split it on d (once a step, outside the
    rematerialised blocks).  The attention leaves of the configurations
    run here split on whole heads, so none of them is gathered."""
    if tp is None:
        return 0
    name, vocab_dim = ("lm_head", 1) if "lm_head" in tp.leaf_split else ("table", 0)
    shape, d = tp.leaf_split[name]
    return 0 if d in (None, vocab_dim) else int(np.prod(shape)) * dtype.itemsize


def time_steps(cfg, mesh, shape, dev, steps=5, warm=2) -> dict:
    """bf16 train steps on a global ``shape`` batch: median ms, tokens/s,
    peak GiB, the model-axis collectives' share."""
    _reset_peak(dev)
    model = build_model(cfg, dev, tp=mesh)
    params, state = init_train_state(model, 0)
    step = make_train_step(model, OptConfig(), {}, _mean_over(mesh.group(mesh.data_axes)))
    batch = {"tokens": _tokens(cfg, shape, 2, dev)[_rows(mesh, shape[0])]}
    clock = CollectiveClock(model.tp.group if model.tp else object(), dev)
    ms, waits, losses = [], [], []
    try:
        reset_launches()
        for i in range(warm + steps):
            dist.barrier()
            _sync(dev)
            clock.on = i >= warm
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            _sync(dev)
            if i >= warm:
                ms.append((time.perf_counter() - t) * 1e3)
                waits.append(clock.take_ms())
        counts = launches()
        dist.barrier()
        (params, state, _), trace = traced(lambda: step(params, state, batch), dev)
    finally:
        clock.close()
    med = statistics.median(ms)
    share = sum(w[0] for w in waits) / sum(ms)
    out = {"ms": ms, "median_ms": med, "tokens_per_s": shape[0] * shape[1] / med * 1e3,
           "peak_gib": _peak_gib(dev), "model_collective_share": share,
           "model_collectives_per_step": waits[0][1],
           "model_collective_bytes_per_step": waits[0][2],
           "model_bytes_by_kind_per_step": waits[0][3], "losses": losses,
           "gathered_bytes_per_step": _gathered_bytes(model.tp, torch.bfloat16),
           "k6": counts["flash_attention"], "k6b": counts["flash_attention_bwd"],
           "k7": counts["wkv6"], "k7b": counts["wkv6_bwd"], "traced_step": trace}
    peaks = torch.zeros(dist.get_world_size(), dtype=torch.float64, device=dev)
    peaks[dist.get_rank()] = out["peak_gib"]
    dist.all_reduce(peaks)
    out["peak_gib_by_rank"] = peaks.tolist()
    del params, state, step, model
    return out


def _generate(model, params, prompts, n, dtype, prefill=transformer.prefill):
    """``prefill`` (K6 on the card) then greedy decode steps; the model
    group's first rank's argmax on every rank.  Returns (tokens [B, n],
    prefill logits, decode-step ms)."""
    b, l = prompts.shape
    cache = model.init_cache(b, l + n, dtype)
    logits, cache = prefill(model.cfg, params, prompts, cache, dtype, tp=model.tp)
    first = logits
    tok = _argmax(model, logits)
    out, ms = [tok], []
    for pos in range(l, l + n - 1):
        _sync(model.device)
        t = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok[:, None], pos, dtype=dtype)
        tok = _argmax(model, logits)
        _sync(model.device)
        ms.append((time.perf_counter() - t) * 1e3)
        out.append(tok)
    return torch.stack(out, 1), first, ms


def _cut(cfg, depth: int):
    """``cfg`` cut to ``depth`` layers; a hybrid to one group of its
    pattern (``hybrid_period`` Mamba2 layers and the shared block)."""
    return dataclasses.replace(cfg, n_layers=cfg.hybrid_period or depth)


def scan_prefill_of(model):
    """``transformer.prefill``'s signature over ``serve.scan_prefill``: the
    recurrent families feed a prompt token by token (decode steps)."""
    return lambda cfg, params, prompts, cache, dtype, tp=None: scan_prefill(
        model, params, cache, prompts, dtype)


def serve_split(cfg, dev, reduced: bool, tag: str = "command-r",
                prefill=transformer.prefill, full: bool = True) -> dict:
    """``cfg`` split over every rank's "model" axis: at depth 2 (a hybrid:
    one group) in fp32 against one card (rank 0's), then, with ``full``, at
    full size in bf16 (the build's peak, prefills, decode steps);
    ``prefill`` is the family's (None: token by token)."""
    out = {}
    world = dist.get_world_size()
    mesh = make_mesh((1, world), ("data", "model"), dev)
    # depth 2 in fp32 against one card
    small = _cut(cfg, 2)
    pre = prefill
    prompts = _tokens(small, (2, 16 if reduced else 64), 3, dev)
    model = build_model(small, dev, tp=mesh)
    with torch.no_grad():
        params = model.init_params(0)
        toks, logits, _ = _generate(model, params, prompts, 8, torch.float32,
                                    pre or scan_prefill_of(model))
    del params, model
    dist.barrier()
    if dist.get_rank() == 0:
        one = build_model(small, dev)
        with torch.no_grad():
            params = one.init_params(0)
            want_toks, want_logits, _ = _generate(one, params, prompts, 8, torch.float32,
                                                  pre or scan_prefill_of(one))
        del params, one
        rel = float((logits - want_logits).abs().max() / want_logits.abs().max())
        same = bool(torch.equal(toks, want_toks))
        out["depth2"] = {"layers": small.n_layers, "logits_rel": rel, "tokens_equal": same,
                         "tokens": toks.tolist()}
        _say(f"[{tag}] {cfg.name} depth {small.n_layers} fp32 at model {world}: prefill logits "
             f"{rel:.3g} of the largest off one card's (tol {LOGIT_TOL}); 8 greedy tokens equal: "
             f"{same}")
        assert rel <= LOGIT_TOL and same, out
    dist.barrier()
    if not full:
        return out
    _reset_peak(dev)
    # full width and depth in bf16
    t = time.perf_counter()
    model = build_model(cfg, dev, tp=mesh)
    with torch.no_grad():
        params = model.init_params(0, torch.bfloat16)
        _sync(dev)
        build_s = time.perf_counter() - t
        build_peak = _peak_gib(dev)
        held = sum(p.numel() * p.element_size() for p in leaves(params)) / GiB
        b, l = (2, 64) if reduced else (4, 2048)
        big = _tokens(cfg, (b, l), 4, dev)
        reset_launches()
        pre = []
        for _ in range(2):
            cache = model.init_cache(b, l, torch.bfloat16)
            _sync(dev)
            t = time.perf_counter()
            prefill(cfg, params, big, cache, torch.bfloat16, tp=model.tp)
            _sync(dev)
            pre.append((time.perf_counter() - t) * 1e3)
        cache_gib = sum(c.numel() * c.element_size() for c in cache.values()) / GiB
        del cache
        k6 = launches()["flash_attention"]
        toks, _, dec = _generate(model, params, big[:, :16], 8, torch.bfloat16, prefill)
        cache = model.init_cache(b, 24, torch.bfloat16)
        prefill(cfg, params, big[:, :16], cache, torch.bfloat16, tp=model.tp)
        dist.barrier()
        _, trace = traced(lambda: model.decode_step(params, cache, toks[:, :1], 16,
                                                    dtype=torch.bfloat16), dev)
        del cache
        peak = _peak_gib(dev)
    out["full"] = {"layers": cfg.n_layers, "build_s": build_s, "build_peak_gib": build_peak,
                   "params_gib_per_rank": held, "prefill_ms": pre, "prefill_shape": [b, l],
                   "kv_cache_gib_per_rank": cache_gib, "decode_ms": dec,
                   "decode_median_ms": statistics.median(dec), "peak_gib": peak,
                   "k6_prefill": k6, "traced_decode_step": trace}
    _say(f"[{tag}] {cfg.name} {cfg.n_layers} layers bf16 at model {world}: {held:.2f} GiB of "
         f"parameters a rank, {build_peak:.2f} GiB at the build's peak ({build_s:.1f} s); "
         f"prefill {[b, l]} {pre} ms (K6 {k6} launches over both, KV cache {cache_gib:.3f} GiB "
         f"a rank); decode-step median of 7 after a 16-token prompt "
         f"{statistics.median(dec):.3f} ms; peak {peak:.2f} GiB; one traced decode step {trace}")
    del params, model
    return out


def _forward_logits(model, params, prompts, dtype):
    """The last position's logits [B, V] of a parallel forward, put
    together over the vocab (the recurrent families' prompt: K7, or the SSD
    and K6, at the prompt's length)."""
    cfg, tp = model.cfg, model.tp
    h = model.forward_hidden(params, {"tokens": prompts}, dtype=dtype, remat=False)[:, -1]
    if tp is None:
        return (h @ transformer.logits_table(cfg, params).to(dtype).T).float()
    table, split = transformer.split_table(cfg, params, dtype, tp)
    logits = h @ table.T
    return (tp.gather(logits, -1) if split else logits).float()


def _grads(model, params, batch, dtype) -> list[torch.Tensor]:
    """The gradients of ``model``'s loss at ``params`` (left without a
    ``.grad``)."""
    for p in leaves(params):
        p.grad = None
    with torch.enable_grad():
        model.loss_fn(params, batch, dtype=dtype).backward()
    out = [p.grad for p in leaves(params)]
    for p in leaves(params):
        p.grad = None
    return out


def _tree_norm(gs) -> float:
    return float(torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in gs)))


def _same_weights(cfg, dev, split, params, batch) -> dict:
    """The split's bf16 gradients at ``params`` (this rank's blocks), put
    together, against the whole model's at the same weights: in bf16, and
    in fp32 as the yardstick of bf16's rounding.  ``ok``: the global norms
    within 2e-2 of the whole model's, or within twice its bf16 gradient's
    distance from its fp32 one (the triangle inequality's bound for two
    gradients each that far from the fp32 one), and the split's distance
    from the fp32 gradient at most twice the whole model's plus 1e-2 of the
    fp32 norm: where one rank rounds a sum of the stream's gradient to bf16
    once, two ranks round each partial and then the sum (the vocab-parallel
    cross entropy, every ``copy``), and these models amplify that rounding
    (a wrong leaf moves its gradient by its whole size)."""
    specs, mesh = split.tp.specs, split.tp.mesh
    got = [gather_leaf(g, spec, mesh)
           for g, spec in zip(_grads(split, params, batch, torch.bfloat16), spec_leaves(specs))]
    whole = map_tree(lambda p: p.detach().requires_grad_(True),
                     gather_tree(params, specs, mesh))
    one = build_model(cfg, dev)
    g16, g32 = _grads(one, whole, batch, torch.bfloat16), _grads(one, whole, batch, torch.float32)
    n, n16, n32 = _tree_norm(got), _tree_norm(g16), _tree_norm(g32)
    e16 = _tree_norm([a.double() - b.double() for a, b in zip(g16, g32)])
    e = _tree_norm([a.double() - b.double() for a, b in zip(got, g32)])
    del got, whole, g16, g32
    norm_tol = max(2e-2 * n16, 2 * e16)
    return {"norm": n, "norm_one": n16, "norm_fp32": n32, "off_fp32": e, "off_fp32_one": e16,
            "norm_tol": norm_tol,
            "ok": abs(n - n16) <= norm_tol and e <= 2 * e16 + 1e-2 * n32}


def _smoke_config(cfg, dev, reduced: bool) -> dict:
    """``cfg`` split over a (1, world) mesh against the whole model on this
    rank: fp32 loss, the prompts' logits, 5 greedy tokens, two bf16 steps,
    the replicated leaves; the kernel launches of the split path alone;
    before each split step, its bf16 gradients against the whole model's at
    the same weights (``_same_weights``)."""
    t0 = time.perf_counter()
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"), dev)
    check_b, train_b, prompt = ((2, 32), (2, 64), (2, 16)) if reduced else (
        (2, 256), (2, 512), (2, 64))
    tokens = _tokens(cfg, check_b, 5, dev)
    train_tokens = _tokens(cfg, train_b, 6, dev)
    prompts = _tokens(cfg, prompt, 7, dev)
    opt = OptConfig(total_steps=2, warmup_steps=1)
    recurrent = cfg.family in ("ssm", "hybrid")

    def run(model):
        with torch.no_grad():
            params = model.init_params(0)
            with block_entries(cfg) as shapes:
                loss = float(model.loss_fn(params, {"tokens": tokens}, dtype=torch.float32))
            stream.append(shapes)
            if recurrent:  # no parallel prefill: the logits of a forward, tokens after 8
                logits = _forward_logits(model, params, prompts, torch.float32)
                toks = torch.from_numpy(greedy_generate(
                    model, params, prompts[:, :8].cpu().numpy(), 5, dtype=torch.float32))
            else:
                toks, logits, _ = _generate(model, params, prompts, 5, torch.float32)
        del params
        params, state = init_train_state(model, 0)
        step = make_train_step(model, opt)
        metrics, same = [], []
        for _ in range(2):
            if model.tp is not None:  # its launches are not the split path's
                before = launches()
                same.append(_same_weights(cfg, dev, model, params, {"tokens": train_tokens}))
                for k, n in launches().items():
                    witness[k] = witness.get(k, 0) + n - before.get(k, 0)
            params, state, m = step(params, state, {"tokens": train_tokens})
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        flags = sharded_flags(model.tp.specs) if model.tp else [True] * len(leaves(params))
        rep = [p.detach().cpu().numpy().tobytes() for p, f in zip(leaves(params), flags)
               if not f]
        return loss, toks, logits, metrics, rep, same

    witness, stream = {}, []
    loss1, toks1, logits1, metrics1, _, _ = run(build_model(cfg, dev))
    _sync(dev)
    reset_launches()
    t = time.perf_counter()
    split = build_model(cfg, dev, tp=mesh)
    loss, toks, logits, metrics, rep, same = run(split)
    _sync(dev)
    path_s = time.perf_counter() - t
    counts = {k: n - witness.get(k, 0) for k, n in launches().items()}
    return {
        "rank": dist.get_rank(), "layers": cfg.n_layers, "loss": loss, "loss_one": loss1,
        # the stream at each block's entry of the fp32 loss: the whole model's, this rank's
        "stream_one": stream[0][0], "stream": stream[1][0],
        "stream_blocks": len(stream[1]), "stream_same": all(x == stream[1][0] for x in stream[1]),
        "loss_rel": abs(loss - loss1) / abs(loss1),
        "logits_rel": float((logits - logits1).abs().max() / logits1.abs().max()),
        "tokens": toks.tolist(), "tokens_one": toks1.tolist(),
        "bf16_metrics": metrics, "bf16_metrics_one": metrics1, "same_weights": same,
        "replicated_leaves": len(rep),
        "replicated_sha": hashlib.sha256(b"".join(rep)).hexdigest(),
        "launches": counts, "path_s": path_s, "seconds": time.perf_counter() - t0,
    }


def smoke(dev, reduced: bool, recurrent: bool = False) -> dict:
    """Phase 58 of ``chip_smoke.py`` (olmo-1b cut to depth 2), or with
    ``recurrent`` phase 60 (rwkv6-3b cut to depth 2, zamba2-2.7b to one
    group): this rank's results."""
    if not recurrent:
        cfg = _cut(get_config("olmo-1b"), 2)
        return _smoke_config(cfg.reduced() if reduced else cfg, dev, reduced)
    t0 = time.perf_counter()
    out = {"rank": dist.get_rank(), "configs": {}}
    for name in ("rwkv6-3b", "zamba2-2.7b"):
        cfg = get_config(name).reduced() if reduced else get_config(name)
        out["configs"][name] = _smoke_config(_cut(cfg, 2), dev, reduced)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/tensor_parallel.py")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recurrent", action="store_true",
                    help="--smoke: phase 60 (rwkv6-3b, zamba2-2.7b) in place of 58")
    ap.add_argument("--backend", default=None, help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--runs", default="olmo,granite,command-r")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    # the float64 witness of a large model may hold the ranks for minutes
    dist.init_process_group(args.backend or ("nccl" if cuda else "gloo"),
                            timeout=datetime.timedelta(seconds=1800))
    try:
        if cuda:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            dev = torch.device("cpu")
        if args.smoke:
            print("RESULT " + json.dumps(smoke(dev, args.reduced, args.recurrent)), flush=True)
            return 0
        card = "cpu"
        if cuda:
            cards = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.split("\n")
            cards = [c.strip() for c in cards if c.strip()]
            card = f"{cards[0]} (x{len(cards)})" if len(set(cards)) == 1 else "; ".join(cards)
        _say(f"[card] {card}; torch {torch.__version__}; world {dist.get_world_size()} "
             f"({dist.get_backend()})")
        world = dist.get_world_size()
        res = {"card": card, "world": world}
        get = (lambda n: get_config(n).reduced()) if args.reduced else get_config
        check_shape, time_shape = ((4, 32), (8, 64)) if args.reduced else ((4, 256), (8, 2048))
        runs = args.runs.split(",")
        if "olmo" in runs:
            cfg = get("olmo-1b")
            meshes = [(world // 2, 2), (1, world)]
            res["olmo-1b"] = {"check": check(cfg, meshes, check_shape, dev, args.reduced)}
            for m in meshes + ["host"]:
                mesh = make_host_mesh("data", dev) if m == "host" else make_mesh(
                    m, ("data", "model"), dev)
                got = time_steps(cfg, mesh, time_shape, dev)
                key = m if m == "host" else f"{m[0]}x{m[1]}"
                res["olmo-1b"][key] = got
                _say(f"[time] olmo-1b {key} bf16 {list(time_shape)}: median {got['median_ms']:.2f} "
                     f"ms a step of {[round(x, 2) for x in got['ms']]}, "
                     f"{got['tokens_per_s']:.0f} tokens/s, peak {got['peak_gib_by_rank']} GiB, "
                     f"model-axis collectives {100 * got['model_collective_share']:.2f} % "
                     f"({got['model_collectives_per_step']} a step, "
                     f"{got['model_bytes_by_kind_per_step']} bytes by kind), K6 {got['k6']} K6b "
                     f"{got['k6b']} over 7 steps; one traced step {got['traced_step']} [{card}]")
        if "granite" in runs:
            cfg = get("granite-3-8b")
            res["granite-3-8b"] = {"check": check(cfg, [(1, world)], check_shape, dev,
                                                  args.reduced)}
            got = time_steps(cfg, make_mesh((1, world), ("data", "model"), dev), time_shape, dev)
            res["granite-3-8b"][f"1x{world}"] = got
            _say(f"[time] granite-3-8b 1x{world} bf16 {list(time_shape)}: median "
                 f"{got['median_ms']:.2f} ms a step of {[round(x, 2) for x in got['ms']]}, "
                 f"{got['tokens_per_s']:.0f} tokens/s, peak {got['peak_gib_by_rank']} GiB, "
                 f"model-axis collectives {100 * got['model_collective_share']:.2f} % "
                 f"({got['model_collectives_per_step']} a step, "
                 f"{got['model_bytes_by_kind_per_step']} bytes by kind), "
                 f"{got['gathered_bytes_per_step']} bytes of leaves gathered a step, K6 {got['k6']} K6b "
                 f"{got['k6b']}; one traced step {got['traced_step']} [{card}]; --mesh host: not run (the whole model's fp32 params, "
                 f"gradients and AdamW moments, 131 GB, exceed a card)")
        if "command-r" in runs:
            res["command-r-plus-104b"] = serve_split(get("command-r-plus-104b"), dev, args.reduced)
        for name in ("rwkv6-3b", "zamba2-2.7b"):
            if name.split("-")[0] not in runs:
                continue
            cfg = get(name)
            res[name] = {"check": check(_cut(cfg, 2), [(world // 2, 2), (1, world)], check_shape,
                                        dev, args.reduced)}
            for m in [(1, world), "host"]:
                mesh = make_host_mesh("data", dev) if m == "host" else make_mesh(
                    m, ("data", "model"), dev)
                got = time_steps(cfg, mesh, time_shape, dev)
                key = m if m == "host" else f"{m[0]}x{m[1]}"
                res[name][key] = got
                _say(f"[time] {name} {key} bf16 {list(time_shape)}, {cfg.n_layers} layers: median "
                     f"{got['median_ms']:.2f} ms a step of {[round(x, 2) for x in got['ms']]}, "
                     f"{got['tokens_per_s']:.0f} tokens/s, peak {got['peak_gib_by_rank']} GiB, "
                     f"model-axis collectives {100 * got['model_collective_share']:.2f} % "
                     f"({got['model_collectives_per_step']} a step, "
                     f"{got['model_collective_bytes_per_step']} bytes: "
                     f"{got['model_bytes_by_kind_per_step']}), K7 {got['k7']} K7b "
                     f"{got['k7b']} K6 {got['k6']} K6b {got['k6b']} over 7 steps; losses "
                     f"{got['losses']}; one traced step {got['traced_step']} [{card}]")
            res[name]["serve"] = serve_split(cfg, dev, args.reduced, "serve", None, full=False)
        _say("RESULT " + json.dumps(res))
        _say(f"[card] {card}")
        missed = [(name, m) for name, r in res.items() if isinstance(r, dict) and "check" in r
                  for m, c in r["check"].items() if isinstance(c, dict) and not c["ok"]]
        _say(f"[check] missed their tolerances: {missed or 'none'}")
        return 1 if missed else 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
