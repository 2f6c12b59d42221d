"""Time the Count-Min kernel (K4), the sketch-only fused pass (K3, the same
kernel on a row block), the histogram (K5), the RWKV-6 recurrence's
backward (K7b) and the attention forward and backward at head dim 80 (K6,
K6b) of one checkout of the port on one card, at the shapes the main path
gives them, so that two checkouts can be compared in one call.

    python3 tools/kernel_ab.py --src DIR [--label NAME] [--reps N]
                               [--kernels k4,k3,k5,k7b,k6_80,k6b_80]

DIR is the root of a checkout: its ``src/repro_torch`` is imported and its
kernels are built into its own ``build/``.  The inputs are made from fixed
seeds, as ``chip_smoke.py`` makes them: the streaming phase's batch 0 (R's
join column and R's rows), 100,000 equal keys, the §9.1 R join column
(10^6 values, 100,000 bins), phase 40's rwkv6-3b shape for K7b
([4, 2048, 40, 64] fp32 from zero, drawn from seed 0 on the card), and for
K6 and K6b the two bf16 shapes at D = 80 (drawn from seed 0 on the card,
the output's gradient from seed 1): hubert-xlarge's [4, 16, 2048, 80]
non-causal and Zamba2-2.7B's shared block's [4, 32, 2048, 80] causal.  Each
result is checked against the checkout's plain version: exactly, K7b to
2e-4 of each gradient's largest entry, K6 and K6b to rtol = atol = 2e-2
and K6b also to 1e-2 by relative norm.  The checkout's own route runs
(``kernel_variant``; printed).  Prints the card and one JSON
line: the label and each case's device ms a call by CUDA-graph replay
(``chip_smoke._graph_ms``), with ``torch.bincount`` beside K5 (CUDA events
around repeated calls, ``chip_smoke._events_ms``: it reads the maximum back
to the host, so it cannot be captured in a graph).  ``--kernels`` picks
the kernels (k4, k3, k5 and k7b by default).  To compare a parent and a
change, run them in turns in separate processes: parent, change, change,
parent.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("k4", "k3", "k5", "k7b", "k6_80", "k6b_80")
# K6/K6b at D = 80: (B, H, L, causal) of hubert-xlarge and Zamba2-2.7B's shared block
D80_SHAPES = {"hubert": (4, 16, 2048, False), "zamba2": (4, 32, 2048, True)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", default="k4,k3,k5,k7b",
                    help="comma-separated subset of " + ", ".join(KERNELS))
    args = ap.parse_args()
    picked = set(args.kernels.split(","))
    if not picked <= set(KERNELS):
        ap.error(f"unknown kernels {sorted(picked - set(KERNELS))}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _close, _events_ms, _graph_ms, _rel_norm_err, _zipf_batch

    sys.path.insert(0, str(args.src.resolve() / "src"))
    from repro_torch.data import paper_2way
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import histogram as hg
    from repro_torch.kernels import ingest_fused as fi
    from repro_torch.kernels import sketch_update as su
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.stream.sketch import _row_seeds

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    seeds, width = _row_seeds(0, 4), 2048  # StreamConfig's sketch: seed 0, depth 4
    batch0 = _zipf_batch(np.random.default_rng(0), 0, 100_000, 25_000, 100_000, 2.0)
    rows0 = torch.from_numpy(batch0["R"].astype(np.int32)).to(dev)
    col0 = rows0[:, 1].contiguous()
    equal = torch.full_like(col0, 7)
    r_col = paper_2way(np.random.default_rng(0), n_r=1_000_000, n_s=100_000)["R"][:, 1]
    hh = torch.from_numpy(r_col.astype(np.int32)).to(dev)
    cases = {
        "k4_batch0": ("k4", lambda: su.cms_update(col0, seeds, width),
                      lambda: su.cms_update_ref(col0, seeds, width)),
        "k4_equal": ("k4", lambda: su.cms_update(equal, seeds, width),
                     lambda: su.cms_update_ref(equal, seeds, width)),
        "k3_sketch_only": (
            "k3", lambda: fi.fused_ingest(rows0, sketch_cols=(1,), seeds=seeds, width=width)[3],
            lambda: fi.fused_ingest_ref(rows0, sketch_cols=(1,), seeds=seeds, width=width)[3]),
        "k5_91": ("k5", lambda: hg.histogram(hh, 100_000),
                  lambda: hg.histogram_ref(hh, 100_000)),
    }
    if "k7b" in picked:
        b, l, h, hd = 4, 2048, 40, 64
        g = torch.Generator(device=dev).manual_seed(0)
        r, k, v, dy = (torch.randn((b, l, h, hd), generator=g, device=dev) for _ in range(4))
        w = 0.6 + 0.399 * torch.rand((b, l, h, hd), generator=g, device=dev)
        u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
        wkv_in = (r, 0.3 * k, v, w, u, dy)
        cases["k7b_rwkv6_3b"] = ("k7b", lambda: wk.wkv6_bwd(*wkv_in),
                                 lambda: wk.wkv6_bwd_ref(*wkv_in))
    if picked & {"k6_80", "k6b_80"}:
        def bwd_ref(q, k, v, do, causal):
            o, lse = fa.flash_attention_ref_lse(q, k, v, causal)
            return fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)

        g = torch.Generator(device=dev).manual_seed(0)
        for tag, (b, h, l, causal) in D80_SHAPES.items():
            q, k, v = (torch.randn((b, h, l, 80), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            do = torch.randn((b, h, l, 80), generator=torch.Generator(device=dev).manual_seed(1),
                             device=dev).to(torch.bfloat16)
            o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
            cases[f"k6_80_{tag}"] = ("k6_80", partial(fa.flash_attention, q, k, v, causal=causal),
                                     partial(fa.flash_attention_ref, q, k, v, causal))
            cases[f"k6b_80_{tag}"] = (
                "k6b_80", partial(fa.flash_attention_bwd, q, k, v, o, lse, do, causal=causal),
                partial(bwd_ref, q, k, v, do, causal))
        print(f"K6 and K6b at D = 80 take {fa.kernel_variant(torch.bfloat16, 80)} and "
              f"{fa.bwd_kernel_variant(torch.bfloat16, 80)}")
    out = {"label": args.label or str(args.src), "card": smi}
    for name, (kernel, fn, ref) in cases.items():
        if kernel not in picked:
            continue
        got, want = fn(), ref()
        if kernel == "k7b":
            err = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(got, want))
            assert err <= 2e-4, (name, err)
        elif kernel == "k6_80":
            assert _close(got, want, 2e-2), name
        elif kernel == "k6b_80":
            assert all(_close(x, y, 2e-2) for x, y in zip(got, want)), name
            rel = max(_rel_norm_err(x, y) for x, y in zip(got, want))
            assert rel <= 1e-2, (name, rel)
        else:
            assert torch.equal(got, want), name
        del got, want
        out[name] = _graph_ms(fn, args.reps)
    if "k5" in picked:
        out["bincount_91"] = _events_ms(lambda: torch.bincount(hh, minlength=100_000), args.reps)
    print(smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
