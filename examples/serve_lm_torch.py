"""Batched serving demo on PyTorch: bucketed waves over the universal decode
engine, on the card.

The twin of ``examples/serve_lm.py`` through the port (``repro_torch``):
builds a small model (the architecture's ``.reduced()`` configuration,
random weights from seed 0), submits a mixed bag of requests with
different prompt lengths, and serves them in length-bucketed waves
(prefill + greedy decode) behind ``BucketServer``.  Works identically for
KV-cache models and recurrent-state models — swap ``--arch rwkv6-3b`` to
serve the attention-free architecture with O(1) state, ``--arch
qwen2-moe-a2.7b`` for the mixture of experts, or ``--arch zamba2-2.7b`` for
the Mamba2 hybrid (SSM and conv states beside a KV cache for each
invocation of its shared attention block).  The weights come
from a ``torch.Generator``, so the tokens differ from the JAX twin's.
``--device`` defaults to ``cuda`` and fails without a card.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch rwkv6-3b | qwen2-moe-a2.7b |
      zamba2-2.7b] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import BucketServer, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device)
    if model.decode_step is None:
        raise SystemExit(f"{args.arch} is encoder-only; it has no decode step")
    params = model.init_params(0)

    rng = np.random.default_rng(0)
    server = BucketServer(model, params, max_batch=4)
    for i in range(args.requests):
        plen = int(rng.choice([8, 8, 8, 16, 16, 24]))  # mixed prompt lengths
        server.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab, size=plen).astype(np.int32),
            max_new=args.max_new,
        ))

    t0 = time.time()
    done = server.drain()
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in done)
    print(f"arch={args.arch}: served {len(done)} requests, "
          f"{total_tokens} tokens in {dt:.2f}s ({total_tokens/dt:.1f} tok/s)")
    for c in sorted(done, key=lambda c: c.uid)[:5]:
        print(f"  req {c.uid}: {c.tokens.tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
