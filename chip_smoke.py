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
     ``examples/multiway_join.py``) on the card against the host oracle;
  7. the streaming engine's fused path on the card: six micro-batches of
     ``benchmarks/bench_stream.py``'s drifting Zipf stream at 100,000 R and
     25,000 S rows each (q=1000), against the host group-by oracle, with
     the kernels' launch counts, per-batch ingest times, the tracer's
     time per span and, from a profiler trace of the last batch, the
     device's busy share;
  8. the baseline path (plain ``map_phase``, the block join, the Count-Min
     kernel) on the first three of those batches: every report equals the
     fused path's;
  9. the fused path with static route tables (``fused_dynamic_routes=
     False``, the static-table pass) on the same three batches: every
     report equals the fused path's;
 10. each stream kernel at the shapes the stream gave it: its device time,
     its wrapper's time, its plain version's time and result, and the
     bound.

Kernel times are device time per call of the kernel's own CUDA functions,
from a ``torch.profiler`` trace of repeated calls (CUDA events around the
wrapper where the trace shows no device time); the wrapper's time, host
work included, is CUDA events around repeated calls.

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

# the CUDA functions of each source, as the profiler names them
JOIN_KERNELS = ("block_join_kernel",)
CMS_KERNELS = ("cms_kernel",)
INGEST_KERNELS = ("tile_kernel", "scan_kernel", "fix_kernel", "cms_kernel")


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


def _traced(fn):
    """(fn's result, device microseconds by CUDA function name) of one
    call of ``fn`` under ``torch.profiler``; the dict is empty where the
    trace holds no device events or the profiler fails (printed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as e:  # the trace is optional: events time the kernels then
        _say(f"[trace] the profiler does not start: {e!r}")
        return fn(), {}
    try:
        out = fn()
    finally:
        prof.__exit__(None, None, None)
    us: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us[ev.name] = us.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return out, us


def _kernel_ms(fn, names, reps: int):
    """(ms, source, wrapper ms, ms by function): the device time per call
    of the CUDA functions whose names contain one of ``names``, from a
    profiler trace of ``reps`` calls after one warm-up call; where the
    trace holds none, CUDA events around the calls (source says which).
    The wrapper's time is CUDA events around ``reps`` calls.
    """
    import torch

    wrapper = _events_ms(fn, reps)

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    _, us = _traced(calls)
    by_fn = {k: v / 1e3 / reps for k, v in us.items() if any(nm in k for nm in names)}
    if not by_fn:
        return wrapper, "events", wrapper, {}
    return sum(by_fn.values()), "trace", wrapper, by_fn


def _short(by_fn) -> str:
    out = []
    for k, v in by_fn.items():
        nm = k.split("(")[0] if "(anonymous namespace)::" not in k else \
            k.split("(anonymous namespace)::")[1].split("(")[0]
        out.append(f"{nm} {v:.4f}")
    return ", ".join(out)


def _plain_ms(fn):
    """(result, ms) of one call of a plain version on the card, host clock
    around a synchronised call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


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
    """Largest |got - want| over paired tensors (None pairs with None);
    shapes must agree."""
    err = 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.shape == w.shape, (tuple(g.shape), tuple(w.shape))
        if w.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _zipf_batch(rng, shift, n_r, n_s, domain, a):
    """benchmarks/bench_stream.py's stream: R(A, B), S(B, C) with Zipf B."""
    import numpy as np

    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _skewed_plan(query, q):
    """A small plan with pinned heavy hitters, so pins and excludes route."""
    import numpy as np

    from repro_torch.core import plan_shares_skew

    rng = np.random.default_rng(7)
    data = {r.name: rng.integers(0, 50, (600, r.arity)).astype(np.int64)
            for r in query.relations}
    for r in query.relations:
        data[r.name][:300, -1] = 7
    return plan_shares_skew(query, data, q=q)


def _ingest_work(rows, enc, dest, n_sketch_cols, depth, width, k):
    """(int32 operations, bytes) of one fused ingest pass on these inputs.

    Operations: per (row, live column) one compare for each pin and each
    exclude value that is on, and for each emission the row does make, 12
    per hashed term (9 for mix32's xors, shifts and multiplies, then the
    modulo, the multiply by the stride and the add) and 2 to rank and count
    it; a padded column costs one compare per row; the Count-Min half
    costs 11 per row, column and sketch row (mix32, modulo, add).  Bytes:
    the rows and the encoding read once; dest and rank over the live
    columns, counts [k] and the Count-Min tables written once."""
    import numpy as np

    n = rows.shape[0]
    live = np.asarray(enc["col_valid"]) != 0
    checks = enc["p_on"].sum(-1) + enc["e_on"].sum((-1, -2))
    hashed = (enc["h_stride"] != 0).sum(-1)
    emitted = (dest >= 0).sum(0).cpu().numpy().astype(np.float64)
    ops = float(n * (checks[live].sum() + (~live).sum()))
    ops += float((emitted * (12 * hashed + 2)).sum())
    ops += 11.0 * n * n_sketch_cols * depth
    n_bytes = 4 * (rows.numel() + sum(np.asarray(v).size for v in enc.values())
                   + 2 * n * int(live.sum()) + k + n_sketch_cols * depth * width)
    return ops, float(n_bytes)


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
    from repro_torch.kernels import _build, launches, reset_launches
    from repro_torch.kernels import block_join as bj
    from repro_torch.kernels import ingest_fused as fi
    from repro_torch.kernels import sketch_update as su
    from repro_torch.mapreduce.keys import static_route_table
    from repro_torch.stream import ObsPolicy, StreamConfig, StreamingJoinEngine
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

    # the fused ingest pass (K2 dense, K3 static) and the Count-Min update
    # (K4): ragged and empty N, W = 1, pins and excludes with V = 8, k not a
    # multiple of 128, hashed values at -2^31 and 2^31-1, seeds >= 2^31
    i32 = np.iinfo(np.int32)
    seeds = (11, 222, (1 << 31) + 5, (1 << 32) - 1)

    def edge_rows(n, arity, seed):
        rows = np.random.default_rng(seed).integers(0, 60, (n, arity)).astype(np.int32)
        if n >= 4:
            rows[-1], rows[-2], rows[-3, 0] = i32.min, i32.max, 7
        return torch.from_numpy(rows).to(dev)

    for query, q_small in [(two_way(), 8), (three_way_paper(), 8)]:
        plan_s = _skewed_plan(query, q_small)
        k_pad = -(-plan_s.total_reducers // 128) * 128
        for rel in query.relations:
            routes = static_route_table(plan_s, rel)
            w = fi.route_width(routes)
            enc = fi.dense_route_encoding(routes, rel.arity, 1 << max(0, (w - 1).bit_length()), 8)
            for n in (0, 1, 4095, 4097, 100_003 if len(query.relations) == 2 else 30_011):
                rows = edge_rows(n, rel.arity, n)
                kw = dict(sketch_cols=(rel.arity - 1,), seeds=seeds, width=2048, k_pad=k_pad)
                got = fi.fused_ingest_dense(rows, enc, **kw)
                torch.cuda.synchronize()
                err = _max_abs_err(got, fi.fused_ingest_dense_ref(rows, enc, **kw))
                _say(f"[check] fused_ingest_dense {rel.name} of {len(query.relations)}-way "
                     f"N={n} Wp={enc['col_base'].shape[0]} k={plan_s.total_reducers} "
                     f"k_pad={k_pad}: max_abs_err={err}")
                assert err == 0
            kw = dict(routes=routes, sketch_cols=(0,), seeds=seeds, width=100,
                      num_reducers=plan_s.total_reducers)
            for mode, mkw in [("route", dict(kw, sketch_cols=())),
                              ("sketch", dict(kw, routes=())), ("both", kw)]:
                rows = edge_rows(10_007, rel.arity, 3)
                got = fi.fused_ingest(rows, **mkw)
                torch.cuda.synchronize()
                err = _max_abs_err(got, fi.fused_ingest_ref(rows, **mkw))
                _say(f"[check] fused_ingest ({mode}) {rel.name} N=10007 W={w} "
                     f"k={plan_s.total_reducers}: max_abs_err={err}")
                assert err == 0
    one = plan_shares_skew(two_way(), {"R": np.zeros((20, 2), np.int64),
                                       "S": np.ones((20, 2), np.int64)}, q=1000)
    for rel in two_way().relations:
        kw = dict(routes=static_route_table(one, rel), num_reducers=one.total_reducers)
        assert fi.route_width(kw["routes"]) == 1
        rows = edge_rows(999, 2, 5)
        err = _max_abs_err(fi.fused_ingest(rows, **kw), fi.fused_ingest_ref(rows, **kw))
        enc = fi.dense_route_encoding(kw["routes"], 2, 1, 8)
        err = max(err, _max_abs_err(fi.fused_ingest_dense(rows, enc, k_pad=128),
                                    fi.fused_ingest_dense_ref(rows, enc, k_pad=128)))
        _say(f"[check] fused_ingest and fused_ingest_dense W=1 {rel.name} N=999: "
             f"max_abs_err={err}")
        assert err == 0
    # destinations that repeat within a row and across rows, with a
    # histogram of 65,536 destinations and with one of 128
    for k_pad in (128, 65_536):
        enc = fi.dense_route_encoding((), 3, 8, max_values=2)
        rng_e = np.random.default_rng(k_pad)
        enc["col_valid"][:7] = 1
        enc["col_base"][:] = [0, 0, 3, 5, 5, 1, 2, 9]
        enc["col_base"][:7] += k_pad - 20
        enc["h_col"][:, 0] = rng_e.integers(0, 3, 8)
        enc["h_seed"][:, 0] = rng_e.integers(i32.min, i32.max, 8)
        enc["h_dim"][:, 0] = [2, 3, 1, 4, 4, 2, 1, 1]
        enc["h_stride"][:, 0] = [1, 1, 0, 2, 2, 3, 0, 0]
        enc["p_col"][3, 0], enc["p_val"][3, 0], enc["p_on"][3, 0] = 1, 2, 1
        enc["e_col"][5, 1], enc["e_val"][5, 1], enc["e_on"][5, 1] = 2, [0, 4], [1, 1]
        rows = torch.from_numpy(rng_e.integers(0, 5, (200_003, 3)).astype(np.int32)).to(dev)
        err = _max_abs_err(fi.fused_ingest_dense(rows, enc, k_pad=k_pad),
                           fi.fused_ingest_dense_ref(rows, enc, k_pad=k_pad))
        _say(f"[check] fused_ingest_dense repeated destinations N=200003 k_pad={k_pad}: "
             f"max_abs_err={err}")
        assert err == 0
    for width in (1, 251, 2048, 20_000):
        vals = np.random.default_rng(width).integers(i32.min, i32.max, 100_003, dtype=np.int64,
                                                     endpoint=True)
        vals[:2], vals[2:60_000] = [i32.min, i32.max], 42
        vals = torch.from_numpy(vals.astype(np.int32)).to(dev)
        got = su.cms_update(vals, seeds, width)
        torch.cuda.synchronize()
        err = _max_abs_err([got], [su.cms_update_ref(vals, seeds, width)])
        _say(f"[check] cms_update N=100003 width={width}: max_abs_err={err}")
        assert err == 0

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
    reset_launches()
    t = time.perf_counter()
    res = run_join(query, data, plan, cap_factor=3.0, device=dev, phase_seconds=phases)
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t
    main_launches = launches()
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
    assert main_launches["reducer_join"] > 0, main_launches
    _say(f"[main] launches during run_join: {main_launches}")
    _say("[main] seconds: data={:.3f} plan={:.3f} oracle(host)={:.3f} ".format(t_data, t_plan, t_oracle)
         + " ".join(f"{k}={v:.4f}" for k, v in phases.items())
         + f" run_join={t_e2e:.4f} plan+run_join={t_plan + t_e2e:.3f}")
    _say(f"[main] peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")

    # ---- 5. each kernel at the main path's shapes ---------------------------
    bins, valids = map_and_bin(query, data, plan, cap_factor=3.0, device=dev)
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
    ms_a, src_a, wrap_a, _ = _kernel_ms(lambda: bj.reducer_join(*ops), JOIN_KERNELS, reps=20)
    ops_a, bytes_a = _join_work(*ops)
    bound_a, by_a = _bound(ops_a, bytes_a)
    _say(f"[K1a] kernel {ms_a:.4f} ms ({src_a}; wrapper {wrap_a:.4f} ms); plain {plain_ms:.1f} ms "
         f"(all {ops[0].shape[0]} reducers, max_abs_err={err_a}); bound {bound_a:.4f} ms by "
         f"{by_a} ({ops_a:.4g} int32 ops, {bytes_a:.4g} bytes)")
    kernels = [{
        "name": "reducer_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_join.cu",
        "replaces": "src/repro/kernels/block_join.py:39",
        "launches": main_launches["reducer_join"], "max_abs_err": err_a,
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
    ms_b, src_b, wrap_b, _ = _kernel_ms(lambda: bj.flat_join(*flat), JOIN_KERNELS, reps=10)
    ops_b, bytes_b = _join_work(*(x[None] for x in flat))
    bound_b, by_b = _bound(ops_b, bytes_b)
    _say(f"[K1b] flat_join {r_hh.shape[0]} x {s_hh.shape[0]} (B={hh}): kernel {ms_b:.4f} ms "
         f"({src_b}; wrapper {wrap_b:.4f} ms); plain {plain_b:.1f} ms (max_abs_err={err_b}); "
         f"bound {bound_b:.4f} ms by {by_b}")
    kernels.append({
        "name": "flat_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_join.cu",
        "replaces": "src/repro/kernels/block_join.py:102",
        "launches": main_launches["flat_join"], "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
        "library_ms": None,
    })
    del bins, valids, ops, flat

    # ---- 6. the paper's 3-way query: the n-way reduce on the card -----------
    q3 = three_way_paper()
    d3 = paper_3way(np.random.default_rng(0), n=2_000, domain=20_000)
    plan3 = plan_shares_skew(q3, d3, q=120)
    reset_launches()
    t = time.perf_counter()
    res3 = run_join(q3, d3, plan3, cap_factor=5.0, device=dev)
    t3 = time.perf_counter() - t
    c3, k3, _, _ = oracle_join(q3, d3)
    _say(f"[3way] reducers={plan3.total_reducers} count={res3.count} checksum={res3.checksum} "
         f"oracle=({c3}, {k3}) overflow={res3.overflow} run_join={t3:.3f} s "
         f"launches={launches()}")
    assert (res3.count, res3.checksum) == (c3, k3) and res3.overflow == 0
    assert res3.comm_tuples == predicted_comm(plan3)

    # ---- 7. the streaming engine, fused path, at scale ----------------------
    t = time.perf_counter()
    rng_s = np.random.default_rng(0)
    batches = [
        _zipf_batch(rng_s, 0 if i < 2 else 33_333, 100_000, 25_000, 100_000,
                    2.0 if i < 2 else 1.4)
        for i in range(6)
    ]
    t_data = time.perf_counter() - t
    cfg = StreamConfig(q=1000, decay=0.5, load_factor=2.0, fused_ingest=True,
                       obs=ObsPolicy(trace=True))
    eng = StreamingJoinEngine(two_way(), cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_stream = time.perf_counter()
    ingest_ms = []
    for i, batch in enumerate(batches):
        def one():
            t = time.perf_counter()
            rep = eng.ingest(batch)
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t) * 1e3)
            return rep

        if i == len(batches) - 1:  # the last batch under the profiler
            rep, busy = _traced(one)
        else:
            rep = one()
        _say(f"[stream] batch {rep.batch}: {ingest_ms[-1]:.1f} ms epoch={rep.plan_epoch} "
             f"replanned={rep.replanned} ({rep.drift_reason or '-'}) k={eng.plan.total_reducers} "
             f"delta={rep.delta_count} comm={rep.comm_tuples} migrated={rep.migrated_tuples} "
             f"max_load={rep.max_load} hh={rep.hh_values}")
    t_stream = time.perf_counter() - t_stream
    stream_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    widths = {r.name: fi.route_width(static_route_table(eng.plan, r)) for r in two_way().relations}
    t = time.perf_counter()
    want_count, want_checksum = groupby_oracle_two_way(two_way(), eng.history_data())
    t_oracle = time.perf_counter() - t
    _say(f"[stream] total count={eng.total_count} checksum={eng.total_checksum}; oracle "
         f"count={want_count} checksum={want_checksum} ({t_oracle:.2f} s on the host)")
    _say(f"[stream] fused_batches={eng.fused_batches} replans={eng.replan_count} "
         f"final k={eng.plan.total_reducers} W={widths} launches={stream_launches}")
    _say("[stream] binned state on the host: " + ", ".join(
        f"{nm} {tuple(b.shape)} ({b.nbytes + v.nbytes} bytes)"
        for nm, (b, v, _) in eng._state.items()))
    _say(f"[stream] seconds: data={t_data:.2f} six ingests={t_stream:.3f} "
         f"ingest ms={[round(x, 1) for x in ingest_ms]}; peak device memory {peak} bytes")
    spans: dict[str, list[float]] = {}
    for ev in eng.obs.tracer.events:
        if ev.get("ph") == "X":
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    for name, durs in sorted(spans.items(), key=lambda kv: -sum(kv[1])):
        _say(f"[stream] span {name}: {sum(durs):.1f} ms total over {len(durs)}")
    busy_ms = sum(busy.values()) / 1e3
    if busy:
        _say(f"[stream] batch 5 under the profiler: device busy {busy_ms:.3f} ms of "
             f"{ingest_ms[-1]:.1f} ms ({100 * busy_ms / ingest_ms[-1]:.3f} %, idle "
             f"{100 - 100 * busy_ms / ingest_ms[-1]:.3f} %); by function (ms): "
             + "; ".join(f"{k[:70]} {v / 1e3:.3f}" for k, v in
                         sorted(busy.items(), key=lambda kv: -kv[1])[:8]))
    else:
        _say("[stream] batch 5 under the profiler: no device events in the trace; "
             "device busy share not measured")
    assert (eng.total_count, eng.total_checksum) == (want_count, want_checksum)
    assert eng.fused_batches == 6 and eng.replan_count >= 1
    assert stream_launches["fused_ingest_dense"] > 0, stream_launches
    assert stream_launches["fused_ingest_sketch"] > 0, stream_launches

    # ---- 8. the baseline path on the first three batches --------------------
    base = StreamingJoinEngine(two_way(), StreamConfig(
        q=1000, decay=0.5, load_factor=2.0, use_device_sketch=True), device=dev)
    reset_launches()
    t = time.perf_counter()
    base_ms = []
    for i, batch in enumerate(batches[:3]):
        t_b = time.perf_counter()
        rep = base.ingest(batch)
        base_ms.append((time.perf_counter() - t_b) * 1e3)
        assert rep == eng.reports[i], f"baseline batch {i} differs from the fused path"
    t_base = time.perf_counter() - t
    base_launches = launches()
    _say(f"[baseline] 3 batches equal the fused reports in {t_base:.3f} s "
         f"(ingest ms {[round(x, 1) for x in base_ms]}); launches={base_launches}; "
         f"total count after 3 batches={base.total_count} (2^31 = {1 << 31})")
    assert base_launches["cms_update"] > 0 and base_launches["reducer_join"] > 0, base_launches
    del base

    # ---- 9. the static-table fused path on the first three batches ----------
    stat = StreamingJoinEngine(two_way(), StreamConfig(
        q=1000, decay=0.5, load_factor=2.0, fused_ingest=True,
        fused_dynamic_routes=False), device=dev)
    reset_launches()
    t = time.perf_counter()
    stat_ms = []
    for i, batch in enumerate(batches[:3]):
        t_b = time.perf_counter()
        rep = stat.ingest(batch)
        stat_ms.append((time.perf_counter() - t_b) * 1e3)
        assert rep == eng.reports[i], f"static-table batch {i} differs from the fused path"
    t_stat = time.perf_counter() - t
    stat_launches = launches()
    _say(f"[static] 3 batches equal the fused reports in {t_stat:.3f} s "
         f"(ingest ms {[round(x, 1) for x in stat_ms]}); launches={stat_launches}")
    assert stat_launches["fused_ingest"] > 0 and stat_launches["fused_ingest_sketch"] > 0, \
        stat_launches
    del stat

    # ---- 10. each stream kernel at the shapes the stream gave it ------------
    seeds = eng.tracker.seeds
    width = cfg.sketch_width
    k_fin = eng.plan.total_reducers
    rows0 = torch.from_numpy(batches[0]["R"].astype(np.int32)).to(dev)
    for rel in two_way().relations:
        routes = static_route_table(eng.plan, rel)
        packed = eng._dense_routes(rel, routes)  # what the engine launches K2 with
        cols = tuple(c for _, c in eng._sketch_cols[rel.name])
        rows = torch.from_numpy(batches[-1][rel.name].astype(np.int32)).to(dev)
        kw = dict(sketch_cols=cols, seeds=seeds, width=width, k_pad=k_fin)
        got = fi.fused_ingest_dense(rows, packed, **kw)
        want, plain_ms = _plain_ms(lambda: fi.fused_ingest_dense_ref(rows, packed.arrays, **kw))
        err = _max_abs_err(got, want)
        assert err == 0
        ms, how, wrap, by_fn = _kernel_ms(lambda: fi.fused_ingest_dense(rows, packed, **kw),
                                          INGEST_KERNELS, reps=20)
        ops, n_bytes = _ingest_work(rows, packed.arrays, got[0], len(cols), len(seeds), width,
                                    k_fin)
        bound, by = _bound(ops, n_bytes)
        _say(f"[K2] fused_ingest_dense {rel.name} N={rows.shape[0]} W={packed.dims[0]} "
             f"k={k_fin}: kernel {ms:.4f} ms ({how}: {_short(by_fn)}; wrapper {wrap:.4f} ms); "
             f"plain {plain_ms:.1f} ms (max_abs_err={err}); bound {bound:.4f} ms by {by} "
             f"({ops:.4g} int32 ops, {n_bytes:.4g} bytes)")
        if rel.name != "R":
            continue
        # the larger pass of the two goes in the kernels line
        kernels.append({
            "name": "fused_ingest_dense", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ingest_fused.cu",
            "replaces": "src/repro/kernels/ingest_fused.py:535",
            "launches": stream_launches["fused_ingest_dense"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
        # K3 with routes and sketch, as the static-table path (phase 9) ran it
        kws = dict(routes=routes, sketch_cols=cols, seeds=seeds, width=width,
                   num_reducers=k_fin)
        got = fi.fused_ingest(rows, **kws)
        want, plain_s = _plain_ms(lambda: fi.fused_ingest_ref(rows, **kws))
        err_s = _max_abs_err(got, want)
        assert err_s == 0
        ms_s, how_s, wrap_s, by_s = _kernel_ms(lambda: fi.fused_ingest(rows, **kws),
                                               INGEST_KERNELS, reps=20)
        enc_s = fi._static_routes(routes, rel.arity, dev).arrays
        ops_s, bytes_s = _ingest_work(rows, enc_s, got[0], len(cols), len(seeds), width, k_fin)
        bound_s, by_bs = _bound(ops_s, bytes_s)
        _say(f"[K3] fused_ingest routes+sketch R N={rows.shape[0]} W={got[0].shape[1]} "
             f"k={k_fin}: kernel {ms_s:.4f} ms ({how_s}: {_short(by_s)}; wrapper {wrap_s:.4f} "
             f"ms); plain {plain_s:.1f} ms (max_abs_err={err_s}); bound {bound_s:.4f} ms by "
             f"{by_bs}")
        kernels.append({
            "name": "fused_ingest", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ingest_fused.cu",
            "replaces": "src/repro/kernels/ingest_fused.py:223",
            "launches": stat_launches["fused_ingest"], "max_abs_err": err_s,
            "ms": ms_s, "plain_ms": plain_s, "bound_ms": bound_s, "bound_by": by_bs,
            "library_ms": None,
        })
        # K3 as batch 0 ran it, before any plan: the sketch-only pass, whose
        # one kernel is the Count-Min kernel
        kw3 = dict(sketch_cols=cols, seeds=seeds, width=width)
        got = fi.fused_ingest(rows0, **kw3)
        want, plain3 = _plain_ms(lambda: fi.fused_ingest_ref(rows0, **kw3))
        err3 = _max_abs_err(got, want)
        assert err3 == 0
        ms3, how3, wrap3, _ = _kernel_ms(lambda: fi.fused_ingest(rows0, **kw3), CMS_KERNELS,
                                         reps=20)
        ops3 = 11.0 * rows0.shape[0] * len(cols) * len(seeds)
        bytes3 = 4.0 * (rows0.numel() + len(cols) * len(seeds) * width)
        bound3, by3 = _bound(ops3, bytes3)
        _say(f"[K3] fused_ingest sketch-only N={rows0.shape[0]}: kernel {ms3:.4f} ms ({how3}; "
             f"wrapper {wrap3:.4f} ms); plain {plain3:.1f} ms (max_abs_err={err3}); bound "
             f"{bound3:.4f} ms by {by3}")
        kernels.append({
            "name": "fused_ingest_sketch", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cms_update.cu",
            "replaces": "src/repro/kernels/ingest_fused.py:223",
            "launches": stream_launches["fused_ingest_sketch"], "max_abs_err": err3,
            "ms": ms3, "plain_ms": plain3, "bound_ms": bound3, "bound_by": by3,
            "library_ms": None,
        })
        # K4 as the baseline tracker ran it: one column of R, 4 seeds
        vals = rows0[:, 1].contiguous()
        got = su.cms_update(vals, seeds, width)
        want, plain4 = _plain_ms(lambda: su.cms_update_ref(vals, seeds, width))
        err4 = _max_abs_err([got], [want])
        assert err4 == 0
        ms4, how4, wrap4, _ = _kernel_ms(lambda: su.cms_update(vals, seeds, width), CMS_KERNELS,
                                         reps=50)
        ops4 = 11.0 * vals.shape[0] * len(seeds)
        bytes4 = 4.0 * (vals.numel() + len(seeds) * width)
        bound4, by4 = _bound(ops4, bytes4)
        _say(f"[K4] cms_update N={vals.shape[0]} depth={len(seeds)} width={width}: "
             f"kernel {ms4:.4f} ms ({how4}; wrapper {wrap4:.4f} ms); plain {plain4:.1f} ms "
             f"(max_abs_err={err4}); bound {bound4:.4f} ms by {by4}")
        kernels.append({
            "name": "cms_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cms_update.cu",
            "replaces": "src/repro/kernels/sketch_update.py:48",
            "launches": base_launches["cms_update"], "max_abs_err": err4,
            "ms": ms4, "plain_ms": plain4, "bound_ms": bound4, "bound_by": by4,
            "library_ms": None,
        })

    _say(f"[done] wall {time.perf_counter() - t_all:.1f} s")
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
