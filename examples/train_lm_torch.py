"""End-to-end training script on the PyTorch port: data pipeline -> train
loop -> checkpoints (the twin of ``examples/train_lm.py``, same flags and
presets, plus ``--device``).

Trains an OLMo-style decoder (or any dense --arch, reduced or full dims)
with AdamW, atomic async checkpoints in the JAX package's layout (either
package resumes the other's), preemption handling and the prefetching
token pipeline.  It computes in bf16 over fp32 master weights (the loss's
default dtype, as in the JAX twin); on the card every full-window
attention layer runs K6 and its backward kernel.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 10
      PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300
      PYTHONPATH=src python examples/train_lm_torch.py --resume ...   # continue

Checkpoints go to ``--ckpt-dir`` (default ``repro_ckpt_torch`` under the
temporary directory, ``$TMPDIR``); pass the same ``--ckpt-dir`` to
``examples/train_lm.py --resume`` to continue the run in the JAX package.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.convert import flat_from_jax_layout, train_state_to_jax_layout
from repro_torch.train import (
    AsyncCheckpointer,
    OptConfig,
    PreemptionGuard,
    init_train_state,
    latest_step,
    load_checkpoint,
    make_train_step,
    restore_tree,
)
from repro_torch.train.optimizer import leaves

PRESETS = {
    # ~2M params: smoke-speed on CPU
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32,
                 d_ff=512, vocab=2048),
    # ~25M params
    "25m": dict(n_layers=6, d_model=384, n_heads=6, n_kv=6, head_dim=64,
                d_ff=1536, vocab=8192),
    # ~100M params (the brief's end-to-end target)
    "100m": dict(n_layers=10, d_model=640, n_heads=10, n_kv=10, head_dim=64,
                 d_ff=2560, vocab=32768),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt_torch"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = dataclasses.replace(
        get_config(args.arch).reduced(), **PRESETS[args.preset], max_seq=args.seq
    )
    model = build_model(cfg, device=args.device)
    n_params = cfg.n_params()
    print(f"arch={args.arch} preset={args.preset} params≈{n_params/1e6:.1f}M "
          f"device={model.device}")

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    params, opt_state = init_train_state(model, 0)
    step_fn = make_train_step(model, opt_cfg)

    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=1)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start, flat = load_checkpoint(args.ckpt_dir)
        tree = restore_tree({"params": params, "opt": opt_state}, flat_from_jax_layout(flat))
        params, opt_state = tree["params"], tree["opt"]
        for p in leaves(params):
            p.requires_grad_(True)
        pipe.step = start  # exact data resume
        print(f"resumed from step {start}")
    pipe.start()

    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
    with PreemptionGuard() as guard:
        t0 = time.time()
        for step in range(start, args.steps):
            tokens = torch.from_numpy(pipe.next_prefetched()).to(model.device)
            params, opt_state, metrics = step_fn(params, opt_state, {"tokens": tokens})
            if step % 10 == 0 or step == args.steps - 1:
                dt = time.time() - t0
                tput = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
                print(
                    f"step {step:5d}  loss={float(metrics['loss']):.4f}  "
                    f"gnorm={float(metrics['grad_norm']):.3f}  "
                    f"lr={float(metrics['lr']):.2e}  tok/s={tput:.0f}"
                )
            stop = guard.should_stop
            if stop or (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, train_state_to_jax_layout({"params": params,
                                                               "opt": opt_state}))
            if stop:
                print("preemption requested -> checkpointed, exiting cleanly")
                break
    ckpt.wait()
    pipe.stop()
    print("done; resume with --resume")


if __name__ == "__main__":
    main()
