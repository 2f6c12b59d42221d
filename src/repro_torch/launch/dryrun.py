"""Multi-pod dry run without XLA: for every (architecture x input shape) cell
of ``configs.SHAPES`` and each production mesh, the bytes one device holds
under the port's sharding rules.  The counterpart of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell on 512 fake host devices and
reads XLA's ``memory_analysis``, ``cost_analysis`` and the compiled HLO
(``hlo_analysis``: FLOPs and HBM bytes with loop trip counts, collective
bytes).  The port has no compiler whose program could be read, so this dry
run reckons what can be known from shapes alone: the per-device bytes of the
parameters (fp32), the gradients (fp32, the params' specs), the AdamW moments
(ZeRO-1 specs), the batch, and the decode cache, each leaf split over the
mesh axes its spec names (``sharding.device_bytes``).  The shapes come from
the port's own ``init_params`` / ``init_cache`` run under
``FakeTensorMode``: nothing is allocated, so a 104B model's cell takes
seconds.

Beside them, ``split_params_bytes`` is what a rank of the port itself
holds of the fp32 parameters split over "model" (every family,
``models.tensor_parallel``; the moe family's experts by expert
parallelism).  The port splits over "model" alone (no FSDP, as the JAX
launcher's ``--mesh prod``), so these are the rules' bytes without the
"data" split of large leaves, the blocks that ``init_params`` keeps under
``tp``.

FLOPs are left out.  The JAX dry run's are per device, read from the
partitioned program XLA compiles; the port compiles none (its layers split
over "model" by hand, ``models.tensor_parallel``), so a count would mean
tracing a full-size step under ``FakeTensorMode`` through the plain
versions the CPU runs: 8 s for olmo-1b at train_4k, but 321 s for rwkv6-3b
at 256 tokens a sequence (its plain recurrence steps token by token;
train_4k has 4,096), timed on a CPU host.  Nor are collectives reckoned,
for the same reason.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]

Each cell is one JSON file ``<mesh>__<arch>__<shape>.json`` under ``--out``
(default ``build/dryrun_torch`` at the checkout's root, which git ignores).
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, all_configs, get_config, skip_reason
from repro_torch.models import build_model
from repro_torch.train.optimizer import init_opt_state

from . import sharding as rules
from .mesh import data_axes, production_axes

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
FLOPS_NOTE = ("not reckoned: per-device FLOPs follow from a partitioned program, which the port "
              "does not compile (its layers place the model-axis collectives by hand)")


def input_shapes(cfg, spec, n_patch: int = 256) -> dict:
    """Fake tensors standing in for the model inputs of one shape cell (the
    JAX dry run's ``input_specs``); call under ``FakeTensorMode``."""
    b, s = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"prefix_embeds": torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16),
                    "labels": torch.empty((b, s), dtype=torch.int32)}
        batch = {"tokens": torch.empty((b, s - (n_patch if cfg.family == "vlm" else 0)),
                                       dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.empty((b, n_patch, cfg.d_model), dtype=torch.bfloat16)
        return batch
    return {"tokens": torch.empty((b, 1), dtype=torch.int32)}  # decode: one new token


def reckon_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """One cell's record: status, devices, and bytes a device by part, the
    params FSDP-sharded over "data" (the JAX dry run's default)."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    record = {"arch": arch, "shape": shape, "mesh": "pod2x16x16" if multi_pod else "pod16x16",
              "status": "ok"}
    reason = skip_reason(cfg, shape)
    if reason:
        record.update(status="skipped", reason=reason)
        return record
    axes = production_axes(multi_pod)
    dp = data_axes(multi_pod)
    data_size = axes["data"] * axes.get("pod", 1)
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        params = model.init_params(0)
        p_spec = rules.param_specs(params, axes["model"], data_size=axes["data"])
        parts = {"params": rules.device_bytes(params, p_spec, axes)}
        batch = input_shapes(cfg, spec)
        parts["batch"] = rules.device_bytes(batch, rules.batch_specs(batch, dp), axes)
        if spec.kind == "train":
            parts["grads"] = parts["params"]
            opt = init_opt_state(params)
            parts["opt"] = rules.device_bytes(opt, rules.opt_specs(p_spec, params, data_size),
                                              axes)
        if spec.kind == "decode":
            cache = model.init_cache(spec.global_batch, spec.seq_len)
            parts["cache"] = rules.device_bytes(
                cache, rules.cache_specs(cache, dp, axes["model"]), axes)
        split = rules.device_bytes(params, rules.param_specs(params, axes["model"]), axes)
    record.update(n_devices=math.prod(axes.values()), bytes_per_device=parts,
                  total_bytes_per_device=sum(parts.values()), split_params_bytes=split,
                  flops=None, flops_note=FLOPS_NOTE)
    return record


def _write(out_dir: Path, record: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{record['mesh']}__{record['arch']}__{record['shape']}.json"
    path.write_text(json.dumps(record, indent=1))
    extra = ""
    if record["status"] == "ok":
        extra = (f" bytes/dev={record['total_bytes_per_device']:.3e} "
                 f"{record['bytes_per_device']} split_params={record['split_params_bytes']}")
    print(f"[dryrun] {record['mesh']} {record['arch']} {record['shape']}: "
          f"{record['status']}{extra}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    archs = args.arch or (sorted(all_configs()) if args.all else None)
    shapes = args.shape or (list(SHAPES) if args.all else None)
    if not archs or not shapes:
        ap.error("pass --arch/--shape or --all")
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                _write(Path(args.out), reckon_cell(a, s, mp))


if __name__ == "__main__":
    main()
