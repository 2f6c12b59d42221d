"""Smoke run of the PyTorch/CUDA port on one card.

Phases:
  1. the card: name and power limit (nvidia-smi), and whether PyTorch runs
     an int32 einsum on CUDA;
  2. build every CUDA kernel from the sources in this checkout (nvcc,
     one process per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card:
     random and ragged shapes, zero and negative weights, checksum
     wraparound;
  4. the main path at the paper's §9.1 scale (|R| = 10^6, |S| = 10^5, one
     heavy hitter B=7 in 10% of tuples, q = 1000) through ``run_join`` on
     the card, checked against a host group-by oracle, with the kernels'
     launch counts;
  5. each kernel at the shapes the main path gives it: time (CUDA events),
     its plain version's time and result, and the bound;
  6. the paper's 3-way query (§9.2, at the scale of
     ``examples/multiway_join.py``) on the card against the host oracle.

Prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Needs one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet), at 700 W: HBM3 3.35 TB/s; int32:
# 64 results per clock per SM for 32-bit integer add and compare (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost (the data sheet's 67 TFLOP/s fp32 is 128
# lanes x 2 flop x the same clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def _say(*args) -> None:
    print(*args, flush=True)


def _events_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(ops: float, n_bytes: float) -> tuple[float, str]:
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _join_work(r_keys, r_w, s_keys, s_w) -> tuple[float, float]:
    """(int32 operations, bytes) of one block join on these inputs: C
    compares and two adds (count, weight) per pair of valid slots; a slot's
    validity is tested once per row, not per pair.  Every input is read
    once and both [K] outputs are written once."""
    c = r_keys.shape[-1]
    n_r = (r_w > 0).sum(dim=-1).double()
    n_s = (s_w > 0).sum(dim=-1).double()
    ops = float((n_r * n_s).sum()) * (c + 2)
    n_bytes = 4 * (r_keys.numel() + r_w.numel() + s_keys.numel() + s_w.numel()) + 8 * r_w.shape[0]
    return ops, float(n_bytes)


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout (no src/repro_torch here)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import plan_shares_skew, three_way_paper, two_way
    from repro_torch.data import paper_2way, paper_3way
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_join as bj
    from repro_torch.mapreduce import (
        LocalJoinSpec,
        binary_join_operands,
        groupby_oracle_two_way,
        map_and_bin,
        oracle_join,
        predicted_comm,
        run_join,
    )
    from repro_torch.mapreduce.hashing import row_weight_torch

    t_all = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _say(f"[card] nvidia-smi: {smi}")
    _say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    a = torch.ones((2, 3, 4), dtype=torch.int32, device=dev)
    try:  # a probe of PyTorch, not a phase: either answer is reported
        torch.einsum("kab,kbc->kac", a, a.transpose(1, 2).contiguous())
        torch.cuda.synchronize()
        _say("[card] int32 einsum on CUDA: runs")
    except RuntimeError as e:
        _say(f"[card] int32 einsum on CUDA: raises ({str(e).splitlines()[0][:120]})")

    # ---- 2. build ----------------------------------------------------------
    built = _build.build_all()
    for b in built.values():
        _say(f"[build] {b.name}: {b.seconds:.2f} s nvcc -> {b.path.name}")
        for line in b.ptxas.splitlines():
            _say(f"[build]   {line.strip()}")

    # ---- 3. kernels against their plain versions, assorted shapes -----------
    rng = np.random.default_rng(0)
    for k, cap_r, cap_s, c in [(1, 8, 8, 1), (3, 100, 77, 1), (5, 513, 1030, 2),
                               (2, 2049, 4100, 3), (6, 3008, 3008, 1), (4, 700, 9, 8)]:
        ops = [rng.integers(0, 5, (k, cap_r, c)), rng.integers(-1, 4, (k, cap_r)),
               rng.integers(0, 5, (k, cap_s, c)), rng.integers(-1, 4, (k, cap_s))]
        ops = [torch.from_numpy(o.astype(np.int32)).to(dev) for o in ops]
        got = bj.reducer_join(*ops)
        torch.cuda.synchronize()
        want = bj.block_join_ref(*ops)
        err = _max_abs_err(got, want)
        _say(f"[check] reducer_join K={k} cap_r={cap_r} cap_s={cap_s} C={c}: max_abs_err={err}")
        assert err == 0
    n = 256  # the wraparound case of the reference kernel tests
    z = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    w = torch.full((n,), 40_000, dtype=torch.int32, device=dev)
    cnt, chk = bj.flat_join(z, w, z, w)
    assert int(cnt) == n * n and int(chk) & 0xFFFFFFFF == (40_000 * 40_000 * n * n) % (1 << 32)
    for n_r, n_s, c in [(5000, 3001, 2), (1, 1, 1), (70_000, 1_000, 1)]:
        ops = [rng.integers(0, 50, (n_r, c)), rng.integers(0, 1 << 31, n_r),
               rng.integers(0, 50, (n_s, c)), rng.integers(0, 1 << 31, n_s)]
        ops = [torch.from_numpy(o.astype(np.int32)).to(dev) for o in ops]
        err = _max_abs_err(bj.flat_join(*ops), bj.tiled_join_ref(*ops))
        _say(f"[check] flat_join N={n_r} M={n_s} C={c}: max_abs_err={err}")
        assert err == 0
    _say("[check] flat_join wraparound 256x256 at weight 40000: ok")

    # ---- 4. main path: the §9.1 join at full scale ----------------------------
    t = time.perf_counter()
    data = paper_2way(np.random.default_rng(0), n_r=1_000_000, n_s=100_000)
    t_data = time.perf_counter() - t
    query = two_way()
    t = time.perf_counter()
    plan = plan_shares_skew(query, data, q=1000)
    t_plan = time.perf_counter() - t
    _say(plan.describe())
    t = time.perf_counter()
    want_count, want_checksum = groupby_oracle_two_way(query, data)
    t_oracle = time.perf_counter() - t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases: dict[str, float] = {}
    bj.reset_launches()
    t = time.perf_counter()
    res = run_join(query, data, plan, cap_factor=3.0, device="cuda", phase_seconds=phases)
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t
    launches = dict(bj.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    _say(f"[main] reducers={plan.total_reducers} count={res.count} checksum={res.checksum} "
         f"overflow={res.overflow} comm={res.comm_tuples} max_load={res.max_load}")
    _say(f"[main] oracle count={want_count} checksum={want_checksum}; the count is "
         f"{'below' if want_count < 1 << 31 else 'NOT below'} 2^31 = {1 << 31}, so the "
         "reference run_join's int32 count would not wrap here")
    assert (res.count, res.checksum) == (want_count, want_checksum)
    assert res.overflow == 0
    assert res.comm_tuples == predicted_comm(plan)
    assert int(res.reducer_loads.sum()) == res.total_comm
    assert launches["reducer_join"] > 0, launches
    _say(f"[main] launches during run_join: {launches}")
    _say("[main] seconds: data={:.3f} plan={:.3f} oracle(host)={:.3f} ".format(t_data, t_plan, t_oracle)
         + " ".join(f"{k}={v:.4f}" for k, v in phases.items())
         + f" run_join={t_e2e:.4f} plan+run_join={t_plan + t_e2e:.3f}")
    _say(f"[main] peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")

    # ---- 5. each kernel at the main path's shapes ---------------------------
    bins, valids = map_and_bin(query, data, plan, cap_factor=3.0, device="cuda")
    ops = binary_join_operands(LocalJoinSpec.from_query(query), bins, valids)
    _say(f"[K1a] reducer_join inputs: r_keys {tuple(ops[0].shape)} s_keys {tuple(ops[2].shape)}")
    got = bj.reducer_join(*ops)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = bj.block_join_ref(*ops)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err_a = _max_abs_err(got, want)
    assert err_a == 0
    assert int(got[0].long().sum()) == res.count
    ms_a = _events_ms(lambda: bj.reducer_join(*ops), reps=20)
    ops_a, bytes_a = _join_work(*ops)
    bound_a, by_a = _bound(ops_a, bytes_a)
    _say(f"[K1a] kernel {ms_a:.4f} ms; plain {plain_ms:.1f} ms (all {ops[0].shape[0]} reducers, "
         f"max_abs_err={err_a}); bound {bound_a:.4f} ms by {by_a} "
         f"({ops_a:.4g} int32 ops, {bytes_a:.4g} bytes)")
    kernels = [{
        "name": "reducer_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_join.cu",
        "replaces": "src/repro/kernels/block_join.py:39",
        "launches": launches["reducer_join"], "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": plain_ms, "bound_ms": bound_a, "bound_by": by_a,
        "library_ms": None,
    }]

    # flat join: the heavy hitter's tuples joined unbinned, one R x S pair
    hh = int(plan.hh_values["B"][0])
    r_hh = torch.from_numpy(data["R"][data["R"][:, 1] == hh].astype(np.int32)).to(dev)
    s_hh = torch.from_numpy(data["S"][data["S"][:, 0] == hh].astype(np.int32)).to(dev)
    flat = (r_hh[:, 1:2].contiguous(), row_weight_torch(r_hh, 0x5EED),
            s_hh[:, 0:1].contiguous(), row_weight_torch(s_hh, 0x5EED + 1))
    got = bj.flat_join(*flat)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = bj.tiled_join_ref(*flat)
    torch.cuda.synchronize()
    plain_b = (time.perf_counter() - t) * 1e3
    err_b = _max_abs_err(got, want)
    assert err_b == 0
    assert int(got[0]) == r_hh.shape[0] * s_hh.shape[0]
    ms_b = _events_ms(lambda: bj.flat_join(*flat), reps=10)
    ops_b, bytes_b = _join_work(*(x[None] for x in flat))
    bound_b, by_b = _bound(ops_b, bytes_b)
    _say(f"[K1b] flat_join {r_hh.shape[0]} x {s_hh.shape[0]} (B={hh}): kernel {ms_b:.4f} ms; "
         f"plain {plain_b:.1f} ms (max_abs_err={err_b}); bound {bound_b:.4f} ms by {by_b}")
    kernels.append({
        "name": "flat_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_join.cu",
        "replaces": "src/repro/kernels/block_join.py:102",
        "launches": launches["flat_join"], "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
        "library_ms": None,
    })
    del bins, valids, ops, flat

    # ---- 6. the paper's 3-way query: the n-way reduce on the card -----------
    q3 = three_way_paper()
    d3 = paper_3way(np.random.default_rng(0), n=2_000, domain=20_000)
    plan3 = plan_shares_skew(q3, d3, q=120)
    bj.reset_launches()
    t = time.perf_counter()
    res3 = run_join(q3, d3, plan3, cap_factor=5.0, device="cuda")
    t3 = time.perf_counter() - t
    c3, k3, _, _ = oracle_join(q3, d3)
    _say(f"[3way] reducers={plan3.total_reducers} count={res3.count} checksum={res3.checksum} "
         f"oracle=({c3}, {k3}) overflow={res3.overflow} run_join={t3:.3f} s "
         f"launches={dict(bj.LAUNCHES)}")
    assert (res3.count, res3.checksum) == (c3, k3) and res3.overflow == 0
    assert res3.comm_tuples == predicted_comm(plan3)

    _say(f"[done] wall {time.perf_counter() - t_all:.1f} s")
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
