"""Batched serving: scan-prefill, greedy decode, bucketed waves; the
counterpart of ``repro.serve.engine``.

The engine builds on a model's ``(init_cache, decode_step)`` pair alone, as
the JAX package's does, so it serves the dense transformer (a KV cache,
position by position) and RWKV-6 (a recurrent state of fixed size, whose
``decode_step`` ignores the position) alike: ``greedy_generate`` prefills
token by token through ``scan_prefill``.  (The parallel prefill, which runs
FlashAttention, is ``models.transformer.prefill``; a dense model's caller
may use it and continue with ``decode_step``.)  Caches and states are
updated in place.

Scheduling: requests are grouped by prompt-length bucket into waves of at
most ``max_batch``; a wave is one prefill plus ``max_new - 1`` decode steps
for the whole batch, and the fullest bucket goes first.

A model split over "model" (``model.tp``) serves with every rank of the
model group calling the same functions on the same prompts: the logits are
put together over the vocab, and each token is the group's first rank's
argmax, broadcast, so every rank feeds the same token to the next step.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch.models.zoo import ModelApi


def scan_prefill(model: ModelApi, params, cache, prompts: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16):
    """Feed a [B, L] prompt through decode_step one token at a time (works
    for every family).  Returns (last logits, cache)."""
    logits = None
    for t in range(prompts.shape[1]):
        logits, cache = model.decode_step(params, cache, prompts[:, t:t + 1], t, dtype=dtype)
    return logits, cache


def greedy_generate(
    model: ModelApi,
    params,
    prompts: np.ndarray,  # [B, L] equal-length prompts
    max_new: int,
    max_seq: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> np.ndarray:
    """Greedy decoding on the model's device; returns [B, max_new] tokens:
    the argmax after the prompt, then ``max_new - 1`` decode steps."""
    b, l = prompts.shape
    max_seq = max_seq or (l + max_new)
    cache = model.init_cache(b, max_seq, dtype=dtype)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32, device=model.device)
    logits, cache = scan_prefill(model, params, cache, toks, dtype)
    tok = _argmax(model, logits)
    out = [tok]
    for pos in range(l, l + max_new - 1):
        logits, cache = model.decode_step(params, cache, tok[:, None], pos, dtype=dtype)
        tok = _argmax(model, logits)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()


def _argmax(model: ModelApi, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row; under ``model.tp`` the model group's
    first rank's, on every rank."""
    tok = torch.argmax(logits, -1).to(torch.int32)
    return tok if model.tp is None else model.tp.broadcast(tok)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [L]
    max_new: int


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray


class BucketServer:
    """Groups requests by prompt length, serves fixed-size waves."""

    def __init__(self, model: ModelApi, params, max_batch: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.dtype = dtype
        self._queue: dict[int, list[Request]] = defaultdict(list)

    def submit(self, req: Request) -> None:
        self._queue[len(req.prompt)].append(req)

    def run_wave(self) -> list[Completion]:
        """Serve the fullest bucket (up to max_batch requests)."""
        if not any(self._queue.values()):
            return []
        length = max(self._queue, key=lambda k: len(self._queue[k]))
        reqs = self._queue[length][: self.max_batch]
        self._queue[length] = self._queue[length][self.max_batch:]
        prompts = np.stack([r.prompt for r in reqs])
        max_new = max(r.max_new for r in reqs)
        out = greedy_generate(self.model, self.params, prompts, max_new, dtype=self.dtype)
        return [
            Completion(uid=r.uid, tokens=out[i, : r.max_new])
            for i, r in enumerate(reqs)
        ]

    def drain(self) -> list[Completion]:
        done: list[Completion] = []
        while any(self._queue.values()):
            done.extend(self.run_wave())
        return done
