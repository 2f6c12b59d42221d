"""Expert parallelism over "model" on cards: the MoE family split over a
(data, model) mesh (``repro_torch.models.moe`` under ``tensor_parallel``,
SharesSkew's replica slots spread over the ranks) held against data
parallelism alone, timed, and served.

  PYTHONPATH=src torchrun --standalone --nproc_per_node 4 tools/expert_parallel.py
  OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
      tools/expert_parallel.py --device cpu --reduced

Four ranks (NCCL, a card each; gloo on the CPU, where ``--reduced`` cuts
every configuration and shape):

1. Check: qwen2-moe-a2.7b at full width, depth 2, fp32 with TF32 off, a
   [4, 256] batch, capacity factor 1.25, on (2, 2) and (1, 4), each with
   0 and 8 replica slots, against the launcher's ``--mesh host`` at world
   4 (every rank the whole model, a row each, the replica plan and aux
   loss the global batch's): the loss (the data groups' mean) to 1e-5
   relative, every gradient (the data-group mean) to 1e-4 of its leaf's
   largest entry, each layer's integer dispatch (slot loads summed over
   the data groups, dropped choices, each replica slot's expert) equal,
   and the replicated leaves' gradients the same bits on every rank of a
   model group.
2. Time: qwen2-moe-a2.7b in bf16 at full depth (24 layers) on (1, 4) with 8
   and 0 replica slots, on a global [8, 2048] batch of ``make_train_step``
   with the launcher's data-group mean: two steps to warm up, then the
   median ms of five, tokens a second, each rank's peak GiB, the share of a
   step the compute stream waits on model-axis collectives (CUDA events
   around each ``all_reduce``/``broadcast`` over the model group), the
   bytes the replica slots' weight fetch sums a step, the step's losses and
   global norms the same bits on every rank of a model group; from one
   step's dispatch (its forward), the drop rate and each rank's row load:
   the choices that arrive at its slots and the rows it keeps, max / mean
   over the ranks (the paper's slowest reducer).
3. Serve: qwen3-moe-30b-a3b at model = 4.  At depth 2 in fp32: the
   prefill logits (``moe.prefill``) of [2, 64] prompts against the same
   weights on one card (rank 0's) to 1e-4 relative, and 8 greedy tokens
   equal.  At full width and depth in bf16: the GiB a rank holds at the
   build's peak, the prefill of [4, 2048] prompts (ms), and the median
   decode-step ms of the 7 steps after 16-token prompts.

``--smoke`` is ``chip_smoke.py``'s phase 59: two ranks on one card over
gloo (CUDA tensors), a (1, 2) mesh, qwen2-moe-a2.7b at full width cut to
depth 2 with 8 replica slots, each rank printing one ``RESULT`` line (with
the stream's shape at a block's entry: the sequence split over "model").

Every figure is printed beside the card's name and power limit, and the
whole record is written to ``build/expert_parallel.json``.  Exits
non-zero when a check misses its tolerance.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tensor_parallel import (  # noqa: E402  (the sibling tool's helpers)
    CollectiveClock,
    _generate,
    _mean,
    _peak_gib,
    _reset_peak,
    _rows,
    _say,
    _sync,
    _tokens,
    block_entries,
    serve_split,
    traced,
)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.launch.sharding import shard_slices, sharded_flags, spec_leaves  # noqa: E402
from repro_torch.launch.train import _mean_over  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.train import OptConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-4
CF = 1.25  # the launcher's capacity factor
GiB = 1 << 30
ROOT = Path(__file__).resolve().parents[1]


class DispatchLog:
    """Each ``moe.dispatch`` while ``on``: its Dispatch (``install`` wraps
    the module's function, for this tool's process only)."""

    def __init__(self):
        self.on, self.calls = False, []

    def install(self) -> None:
        orig = moe.dispatch

        def recorded(*a, **kw):
            disp = orig(*a, **kw)
            if self.on:
                self.calls.append(disp)
            return disp

        moe.dispatch = recorded

    def take(self) -> list:
        calls, self.calls, self.on = self.calls, [], False
        return calls


LOG = DispatchLog()


def _integers(calls, mesh) -> list[dict]:
    """Each layer's slot loads (summed over its groups and the data groups),
    dropped choices and replica slots' experts, as host lists."""
    group = mesh.group(mesh.data_axes)
    out = []
    for disp in calls:
        loads = disp.loads.sum(1).long()
        dropped = (disp.pos < 0).sum().reshape(1)
        both = torch.cat([loads, dropped])
        dist.all_reduce(both, group=group)
        out.append({"loads": both[:-1].tolist(), "dropped": int(both[-1]),
                    "slot_expert": (None if disp.slot_expert is None
                                    else disp.slot_expert.tolist())})
    return out


def _rank_rows(calls, tp, n_experts: int) -> dict:
    """From one forward's dispatches: the choices arriving at each rank's
    slots and the rows it keeps (at most ``cap`` a slot and group), summed
    over the layers, and the drop rate."""
    ranks = tp.slot_ranks(n_experts, calls[0].loads.shape[0] - n_experts) if tp else None
    size = tp.size if tp else 1
    arrive, kept, dropped, choices = [0] * size, [0] * size, 0, 0
    for disp in calls:
        s, g = disp.loads.shape
        cap = disp.src.numel() // (s * g)
        loads = disp.loads.long()
        per_slot_in = loads.sum(1).tolist()
        per_slot_kept = loads.clamp(max=cap).sum(1).tolist()
        for slot in range(s):
            r = ranks[slot] if ranks else 0
            arrive[r] += per_slot_in[slot]
            kept[r] += per_slot_kept[slot]
        dropped += int((disp.pos < 0).sum())
        choices += disp.pos.numel()
    stat = lambda xs: {"by_rank": xs, "max_over_mean": max(xs) / (sum(xs) / len(xs))}
    return {"arrivals": stat(arrive), "kept_rows": stat(kept), "drop_rate": dropped / choices}


def _replicated_sha(tensors, flags) -> str:
    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                   for t, f in zip(tensors, flags) if not f)).hexdigest()


def _same_in_model_group(value, mesh) -> bool:
    """Is ``value`` (a picklable) the same on every rank of this rank's
    model group?  Every rank of the world calls it."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (mesh.index(mesh.data_axes), value))
    mine = mesh.index(mesh.data_axes)
    return len({json.dumps(v) for d, v in got if d == mine}) == 1


def _loss_grads(cfg, mesh, tokens, extra, dev):
    """fp32 loss (the data groups' mean), this rank's gradients (data-group
    mean, on the host), each layer's integer dispatch, and whether the
    replicated leaves' gradients are the same bits across the model group."""
    model = build_model(cfg, dev, tp=mesh)
    params = model.init_params(0)  # no AdamW moments: the check needs none
    for p in leaves(params):
        p.requires_grad_(True)
    group = mesh.group(mesh.data_axes)
    LOG.on = True
    loss = model.loss_fn(params, {"tokens": tokens[_rows(mesh, tokens.shape[0])]},
                         dtype=torch.float32, capacity_factor=CF, extra_slots=extra, group=group)
    calls = LOG.take()
    loss.backward()
    grads = _mean_over(group)([p.grad for p in leaves(params)])
    flags = sharded_flags(model.tp.specs) if model.tp else [True] * len(grads)
    same = _same_in_model_group(_replicated_sha(grads, flags), mesh) if model.tp else True
    out = (float(_mean(loss, mesh)), [g.cpu() for g in grads], model.tp,
           _integers(calls, mesh), same)
    del params, grads, loss, model, calls
    return out


def check(cfg, meshes, extras, shape, dev) -> dict:
    """The split runs' loss, gradients and dispatch against ``--mesh host``
    at this world, for each number of replica slots."""
    tokens = _tokens(cfg, shape, 1, dev)
    out = {}
    for extra in extras:
        _reset_peak(dev)
        host_loss, host_grads, _, host_ints, _ = _loss_grads(
            cfg, make_host_mesh("data", dev), tokens, extra, dev)
        for m in meshes:
            loss, grads, tp, ints, same = _loss_grads(
                cfg, make_mesh(m, ("data", "model"), dev), tokens, extra, dev)
            worst = 0.0
            for g, want, spec in zip(grads, host_grads, spec_leaves(tp.specs)):
                block = want[shard_slices(tuple(want.shape), spec, tp.mesh)]
                err = torch.tensor([float((g - block).abs().max())], device=dev)
                dist.all_reduce(err, op=dist.ReduceOp.MAX, group=tp.group)
                worst = max(worst, float(err) / max(float(want.abs().max()), 1e-30))
            rel = abs(loss - host_loss) / abs(host_loss)
            equal = ints == host_ints
            key = f"{m[0]}x{m[1]}_x{extra}"
            out[key] = {"loss": loss, "host_loss": host_loss, "loss_rel": rel,
                        "grad_rel_max": worst, "dispatch_equal": equal,
                        "replicated_grads_same_bits": same,
                        "dropped_by_layer": [i["dropped"] for i in ints],
                        "slot_expert_layer0": ints[0]["slot_expert"]}
            _say(f"[check] {cfg.name} {m} extra_slots {extra}: fp32 loss {loss!r} vs --mesh "
                 f"host {host_loss!r} (rel {rel:.3g}, tol {LOSS_TOL}); gradients {worst:.3g} "
                 f"of each leaf's largest entry at most (tol {GRAD_TOL}); each layer's slot "
                 f"loads, drops {out[key]['dropped_by_layer']} and replica slots' experts "
                 f"{ints[0]['slot_expert']} (layer 0) equal: {equal}; replicated gradients the "
                 f"same bits in each model group: {same}")
            assert rel <= LOSS_TOL and worst <= GRAD_TOL and equal and same, out[key]
            del grads
        del host_grads
    return out


def time_steps(cfg, mesh, shape, extra, dev, steps=5, warm=2) -> dict:
    """bf16 train steps on a global ``shape`` batch: median ms, tokens/s,
    peak GiB, the model-axis collectives' share, the fetch's bytes, the
    per-rank row loads of one step's forward."""
    _reset_peak(dev)
    model = build_model(cfg, dev, tp=mesh)
    params, state = init_train_state(model, 0)
    group = mesh.group(mesh.data_axes)
    kw = {"capacity_factor": CF, "extra_slots": extra, "group": group}
    step = make_train_step(model, OptConfig(), kw, _mean_over(group))
    batch = {"tokens": _tokens(cfg, shape, 2, dev)[_rows(mesh, shape[0])]}
    clock = CollectiveClock(model.tp.group if model.tp else object(), dev)
    ms, waits, metrics, loads = [], [], [], None
    try:
        reset_launches()
        for i in range(warm + steps):
            dist.barrier()
            _sync(dev)
            clock.on = i >= warm
            LOG.on = i == warm - 1  # one warm-up step's forward dispatches
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
            _sync(dev)
            if i == warm - 1:
                loads = _rank_rows(LOG.take()[:cfg.n_layers], model.tp, cfg.n_experts)
            if i >= warm:
                ms.append((time.perf_counter() - t) * 1e3)
                waits.append(clock.take_ms())
        counts = launches()
        dist.barrier()
        (params, state, _), trace = traced(lambda: step(params, state, batch), dev)
        dist.barrier()
        (params, state, _), host = host_ops(lambda: step(params, state, batch), dev)
    finally:
        clock.close()
    flags = sharded_flags(model.tp.specs) if model.tp else [True] * len(leaves(params))
    same = _same_in_model_group([metrics, _replicated_sha(leaves(params), flags)], mesh)
    med = statistics.median(ms)
    fetch = moe.fetch_bytes(cfg, extra, torch.bfloat16, model.tp)
    out = {"ms": ms, "median_ms": med, "tokens_per_s": shape[0] * shape[1] / med * 1e3,
           "peak_gib": _peak_gib(dev), "model_collective_share": sum(w[0] for w in waits) / sum(ms),
           "model_collectives_per_step": waits[0][1],
           "model_bytes_by_kind_per_step": waits[0][3], "metrics": metrics,
           "metrics_and_replicated_same_bits": same,
           # forward, the rematerialised forward, and the backward's gradients
           "fetch_bytes_per_layer": fetch, "fetch_bytes_per_step": 3 * cfg.n_layers * fetch,
           "row_loads": loads, "k6": counts["flash_attention"],
           "k6b": counts["flash_attention_bwd"], "traced_step": trace, "host_ops": host}
    peaks = torch.zeros(dist.get_world_size(), dtype=torch.float64, device=dev)
    peaks[dist.get_rank()] = out["peak_gib"]
    dist.all_reduce(peaks)
    out["peak_gib_by_rank"] = peaks.tolist()
    assert same, "a step's metrics or replicated leaves differ within a model group"
    del params, state, step, model
    return out


def host_ops(fn, dev, n=10) -> tuple:
    """(fn's result, rank 0's host time by PyTorch op over one call: the n
    largest self times in ms, with their call counts) under
    ``torch.profiler`` with the CPU activity alone; the other ranks, and the
    CPU, run ``fn`` unprofiled (None)."""
    if dev.type != "cuda" or dist.get_rank() != 0:
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
        torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t) * 1e3
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:n]
    return out, {"wall_ms": wall, "self_ms": {e.key[:70]: [round(e.self_cpu_time_total / 1e3, 3),
                                                          e.count] for e in top}}


def smoke(dev, reduced: bool) -> dict:
    """Phase 59 of ``chip_smoke.py``: this rank's results.  The ranks also
    share the whole model's run on one rank: the first runs its checks, the
    second its train steps."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=2)
    cfg = cfg.reduced() if reduced else cfg
    extra = 8
    mesh = make_mesh((1, dist.get_world_size()), ("data", "model"), dev)
    check_b, train_b, prompt = ((2, 32), (2, 64), (2, 16)) if reduced else (
        (2, 256), (2, 512), (2, 64))
    tokens = _tokens(cfg, check_b, 5, dev)
    train_tokens = _tokens(cfg, train_b, 6, dev)
    prompts = _tokens(cfg, prompt, 7, dev)
    opt = OptConfig(total_steps=2, warmup_steps=1)
    kw = {"capacity_factor": CF, "extra_slots": extra}

    def check_part(model):
        with torch.no_grad():
            params = model.init_params(0)
            LOG.on = True
            with block_entries(cfg) as shapes:
                loss = float(model.loss_fn(params, {"tokens": tokens}, dtype=torch.float32, **kw))
            ints = [[d.loads.sum(1).tolist(), int((d.pos < 0).sum()), d.slot_expert.tolist()]
                    for d in LOG.take()]
            toks, logits, _ = _generate(model, params, prompts, 5, torch.float32, moe.prefill)
        return {"loss": loss, "ints": ints, "tokens": toks.tolist(), "logits": logits.cpu(),
                "stream": shapes[0], "stream_same": all(x == shapes[0] for x in shapes)}

    def train_part(model):
        params, state = init_train_state(model, 0)
        step = make_train_step(model, opt, kw)
        metrics = []
        for _ in range(2):
            params, state, m = step(params, state, {"tokens": train_tokens})
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        flags = sharded_flags(model.tp.specs) if model.tp else [True] * len(leaves(params))
        return {"metrics": metrics, "replicated_sha": _replicated_sha(leaves(params), flags),
                "replicated_leaves": flags.count(False)}

    # the whole model on one rank: the checks on the first rank, the steps on the second
    mine = (check_part if dist.get_rank() % 2 == 0 else train_part)(build_model(cfg, dev))
    _sync(dev)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    one = {**parts[0], **parts[1]}
    split = build_model(cfg, dev, tp=mesh)
    reset_launches()
    t = time.perf_counter()
    got = {**check_part(split), **train_part(split)}
    _sync(dev)
    path_s = time.perf_counter() - t
    counts = launches()
    logits_rel = float((got["logits"] - one["logits"]).abs().max() / one["logits"].abs().max())
    return {
        "rank": dist.get_rank(), "loss": got["loss"], "loss_one": one["loss"],
        "stream": got["stream"], "stream_one": one["stream"], "stream_same": got["stream_same"],
        "loss_rel": abs(got["loss"] - one["loss"]) / abs(one["loss"]),
        "logits_rel": logits_rel, "dispatch_equal": got["ints"] == one["ints"],
        "dropped": [i[1] for i in got["ints"]], "slot_expert": got["ints"][0][2],
        "tokens": got["tokens"], "tokens_one": one["tokens"],
        "bf16_metrics": got["metrics"], "bf16_metrics_one": one["metrics"],
        "replicated_leaves": got["replicated_leaves"], "replicated_sha": got["replicated_sha"],
        "fetch_bytes_per_layer": moe.fetch_bytes(cfg, extra, torch.bfloat16, split.tp),
        "launches": counts, "path_s": path_s, "seconds": time.perf_counter() - t0,
    }


def _card() -> str:
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split("\n")
    cards = [c.strip() for c in cards if c.strip()]
    return f"{cards[0]} (x{len(cards)})" if len(set(cards)) == 1 else "; ".join(cards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/expert_parallel.py")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", default=None, help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--runs", default="check,time,serve")
    args = ap.parse_args(argv)
    LOG.install()
    cuda = args.device == "cuda"
    dist.init_process_group(args.backend or ("nccl" if cuda else "gloo"),
                            timeout=datetime.timedelta(seconds=600))
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
            print("RESULT " + json.dumps(smoke(dev, args.reduced)), flush=True)
            return 0
        card = _card() if cuda else "cpu"
        world = dist.get_world_size()
        _say(f"[card] {card}; torch {torch.__version__}; world {world} ({dist.get_backend()})")
        res = {"card": card, "world": world}
        get = (lambda n: get_config(n).reduced()) if args.reduced else get_config
        runs = args.runs.split(",")
        qwen2 = get("qwen2-moe-a2.7b")
        if "check" in runs:
            shape = (4, 32) if args.reduced else (4, 256)
            res["check"] = check(dataclasses.replace(qwen2, n_layers=2),
                                 [(world // 2, 2), (1, world)], [0, 8], shape, dev)
        if "time" in runs:
            shape = (8, 64) if args.reduced else (8, 2048)
            mesh = make_mesh((1, world), ("data", "model"), dev)
            for extra in (8, 0):
                got = time_steps(qwen2, mesh, shape, extra, dev)
                res[f"time_1x{world}_x{extra}"] = got
                ld = got["row_loads"]
                _say(f"[time] {qwen2.name} {qwen2.n_layers} layers 1x{world} extra_slots {extra} "
                     f"bf16 {list(shape)}: median {got['median_ms']:.2f} ms a step of "
                     f"{[round(x, 2) for x in got['ms']]}, {got['tokens_per_s']:.0f} tokens/s, "
                     f"peak {got['peak_gib_by_rank']} GiB, model-axis collectives "
                     f"{100 * got['model_collective_share']:.2f} % "
                     f"({got['model_collectives_per_step']} a step, "
                     f"{got['model_bytes_by_kind_per_step']} bytes by kind), replica-slot fetch "
                     f"{got['fetch_bytes_per_step']} bytes a step ({got['fetch_bytes_per_layer']} a "
                     f"layer's forward); drop rate {ld['drop_rate']:.4f}, arrivals a rank "
                     f"{ld['arrivals']['by_rank']} (max/mean {ld['arrivals']['max_over_mean']:.4f}),"
                     f" kept rows {ld['kept_rows']['by_rank']} (max/mean "
                     f"{ld['kept_rows']['max_over_mean']:.4f}); K6 {got['k6']} K6b {got['k6b']} "
                     f"over 7 steps; losses and norms {got['metrics']}; one traced step "
                     f"{got['traced_step']}; the host's ops in another {got['host_ops']} [{card}]")
        if "serve" in runs:
            res["serve"] = serve_split(get("qwen3-moe-30b-a3b"), dev, args.reduced, "serve",
                                       moe.prefill)
        if dist.get_rank() == 0:
            (ROOT / "build").mkdir(exist_ok=True)
            (ROOT / "build" / "expert_parallel.json").write_text(json.dumps(res, indent=1))
        _say("RESULT " + json.dumps({k: v for k, v in res.items()
                                     if not k.startswith("time")}))
        _say(f"[card] {card}")
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
