"""The distributed shuffle and the int8 all-reduce across several ranks:
chip_smoke.py's phase 6b and ``train.compression`` at a world above one.
Every rank builds the same §9.1 data and plan, runs
``run_distributed`` three times over the default group (NCCL on the card,
one card a rank; gloo on the CPU), then the §9.2 3-way query; rank 0 holds
each result against ``run_join`` on its own card and against the host
oracle (count, checksum, every ``comm_tuples`` entry, every reducer's load,
no overflow) and prints the wall times.

  PYTHONPATH=src torchrun --nproc_per_node 4 tools/multi_card.py
  PYTHONPATH=src torchrun --nproc_per_node 4 tools/multi_card.py --device cpu \
      --n-r 40000 --n-s 4000 --q 200

``--parts compress`` instead runs ``compressed_tree_psum`` over one step's
gradient tree of reduced olmo-1b (seed 0's weights; each rank's own batch,
``TokenPipeline(seed=rank)``, its fp32 gradient computed on the CPU on one
thread, so every backend's ranks start from the same bits), three steps of
error feedback (the residuals carried, step s's gradient scaled by s + 1),
and writes every step's shared scales, int32 sums, means and residuals,
hashed, to ``--out``; ``--against FILE`` holds them to another run's bit
for bit (four NCCL ranks on the cards against four gloo ranks on the CPU):

  OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --nproc_per_node 4 tools/multi_card.py \
      --parts compress --device cpu --out build/compress_gloo.json
  PYTHONPATH=src torchrun --nproc_per_node 4 tools/multi_card.py --parts compress \
      --against build/compress_gloo.json

It prints the bytes each rank puts on the wire, against one fp32
all-reduce of the same tree.  Exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import plan_shares_skew, three_way_paper, two_way
from repro_torch.data import paper_2way, paper_3way
from repro_torch.distributed import world
from repro_torch.mapreduce import groupby_oracle_two_way, oracle_join, run_distributed, run_join

COMPRESS_STEPS = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_grads(rank: int) -> list[torch.Tensor]:
    """Reduced olmo-1b's fp32 gradient at seed 0's weights on this rank's
    batch, on the CPU on one thread (the same bits on every backend)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import leaves

    torch.set_num_threads(1)
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init_params(0)
    for p in leaves(params):
        p.requires_grad_(True)
    tokens = torch.from_numpy(TokenPipeline(cfg.vocab, batch=4, seq=32, seed=rank).next_batch())
    model.loss_fn(params, {"tokens": tokens}, dtype=torch.float32).backward()
    return [p.grad.detach() for p in leaves(params)]


def compress(group, dev: torch.device, args) -> bool:
    """``compressed_tree_psum`` over three steps of error feedback; rank 0
    writes or checks the hashes of every scale, int32 sum, mean and
    residual (``--out``, ``--against``)."""
    import hashlib
    import json

    from repro_torch.train import compression

    rank, n = group.rank(), group.size()
    grads = [g.to(dev) for g in _step_grads(rank)]
    seen = []  # the buffers the compression all-reduces, after each call

    class _Wire:  # ``dist`` as ``compression`` sees it, recording each all_reduce
        def __getattr__(self, name):
            return getattr(dist, name)

        @staticmethod
        def all_reduce(t, *a, **kw):
            out = dist.all_reduce(t, *a, **kw)
            seen.append(t)
            return out

    wire = compression.dist
    compression.dist = _Wire()
    try:
        residuals = compression.init_residuals(grads)
        steps = []
        for s in range(COMPRESS_STEPS):
            seen.clear()
            mean, residuals = compression.compressed_tree_psum(
                [g * (s + 1) for g in grads], residuals, group)
            scales, sums = seen[0::2], seen[1::2]
            assert all(x.dtype == torch.float32 for x in scales)
            assert all(x.dtype == torch.int32 for x in sums)
            steps.append({k: hashlib.sha256(b"".join(
                t.detach().cpu().contiguous().numpy().tobytes() for t in ts)).hexdigest()
                for k, ts in (("scale", scales), ("int32_sum", sums), ("mean", mean),
                              ("residual", residuals))})
            wire_bytes = sum(x.numel() * x.element_size() for x in scales + sums)
    finally:
        compression.dist = wire
    fp32_bytes = sum(g.numel() * 4 for g in grads)
    # every rank's own hashes, gathered: the results must agree over the ranks
    every = [None] * n
    dist.all_gather_object(every, steps, group=group)
    if rank != 0:
        return True
    same_ranks = all(e[s]["mean"] == steps[s]["mean"] and e[s]["int32_sum"] ==
                     steps[s]["int32_sum"] and e[s]["scale"] == steps[s]["scale"]
                     for e in every for s in range(COMPRESS_STEPS))
    res = {"world": n, "backend": dist.get_backend(group), "device": dev.type,
           "leaves": len(grads), "values": sum(g.numel() for g in grads),
           "wire_bytes_a_rank": wire_bytes, "fp32_allreduce_bytes_a_rank": fp32_bytes,
           "steps": every}
    print(f"[compress] world {n} ({res['backend']}, {dev.type}): {COMPRESS_STEPS} steps of "
          f"compressed_tree_psum over reduced olmo-1b's gradient ({res['leaves']} leaves, "
          f"{res['values']} values); scales, int32 sums and means the same on every rank: "
          f"{same_ranks}; bytes a rank all-reduces a step {wire_bytes} (the int8 grid summed "
          f"as int32, a scale a leaf) against one fp32 all-reduce's {fp32_bytes} "
          f"({wire_bytes / fp32_bytes:.4f}x)", flush=True)
    ok = same_ranks
    if args.against:
        want = json.load(open(args.against))
        same = want["steps"] == every
        print(f"[compress] against {args.against} ({want['backend']}, {want['device']}, world "
              f"{want['world']}): every rank's scales, int32 sums, means and residuals the "
              f"same bits at every step: {same}", flush=True)
        ok = ok and same
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", default="join", help="join, compress or both (comma-separated)")
    ap.add_argument("--n-r", type=int, default=1_000_000)
    ap.add_argument("--n-s", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=1000)
    ap.add_argument("--out", default="", help="compress: write the hashes here")
    ap.add_argument("--against", default="", help="compress: hold them to this file's")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    with world(args.device) as (group, dev):
        if "compress" in parts and not compress(group, dev, args):
            raise SystemExit("[compress] mismatch")
        if "join" not in parts:
            return
        rank, n = group.rank(), group.size()
        cases = []
        query = two_way()
        data = paper_2way(np.random.default_rng(0), n_r=args.n_r, n_s=args.n_s)
        cases.append(("§9.1 2-way", query, data, plan_shares_skew(query, data, q=args.q), 3.0,
                      lambda: groupby_oracle_two_way(query, data)))
        q3 = three_way_paper()
        d3 = paper_3way(np.random.default_rng(0), n=2000, domain=20000)
        cases.append(("§9.2 3-way", q3, d3, plan_shares_skew(q3, d3, q=120), 5.0,
                      lambda: oracle_join(q3, d3)[:2]))
        for name, q_, d_, plan, cap, oracle in cases:
            secs = []
            for _ in range(3):  # the first warms the group and the caches
                dist.barrier(group)
                _sync(dev)
                t = time.perf_counter()
                res = run_distributed(q_, d_, plan, group=group, cap_factor=cap, device=dev)
                _sync(dev)
                secs.append(time.perf_counter() - t)
            if rank != 0:
                continue
            t = time.perf_counter()
            base = run_join(q_, d_, plan, cap_factor=cap, device=dev)
            _sync(dev)
            base_s = time.perf_counter() - t
            want = tuple(int(x) for x in oracle())
            print(f"[multi] {name}: world {n} ({group.name()}, {dev.type}), reducers "
                  f"{plan.total_reducers}: count={res.count} checksum={res.checksum} "
                  f"overflow={res.overflow} comm={res.comm_tuples}; run_distributed wall s "
                  f"{[round(x, 4) for x in secs]}, run_join {base_s:.4f} s; oracle {want}",
                  flush=True)
            same = (res.count, res.checksum, res.comm_tuples, res.overflow) == (
                base.count, base.checksum, base.comm_tuples, 0)
            same = same and np.array_equal(res.reducer_loads, base.reducer_loads)
            assert same and (res.count, res.checksum) == want, (res, base, want)
            print(f"[multi] {name}: equal to run_join in every field and to the oracle",
                  flush=True)


if __name__ == "__main__":
    main()
