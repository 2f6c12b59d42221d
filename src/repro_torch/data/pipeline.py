"""Deterministic sharded token pipeline with checkpointable state: a copy
of ``repro.data.pipeline`` (numpy only), so one seed gives both packages
the same batches bit for bit.

A synthetic corpus (seeded, reproducible) stands in for real shards: each
host generates only its shard's tokens (index-based, no coordination), and
the pipeline's position is one integer — saved inside the checkpoint, so a
restore resumes mid-epoch exactly.  Over-decomposition + a prefetch thread
gives host-level straggler tolerance: batches are produced ahead of
consumption and a slow generator never stalls the step loop until the
buffer drains.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class TokenPipeline:
    def __init__(
        self,
        vocab: int,
        batch: int,
        seq: int,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
        prefetch: int = 2,
    ):
        if batch % num_shards:
            raise ValueError("global batch must divide num_shards")
        self.vocab = vocab
        self.batch = batch // num_shards
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.step = 0
        self._prefetch = prefetch
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None

    # ---- deterministic access by index (seekable -> checkpointable) -------
    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        # mildly Zipfian token stream (realistic vocab skew for the
        # embedding-gather analysis)
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        return ((z - 1) % self.vocab).astype(np.int32)

    def next_batch(self) -> np.ndarray:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # ---- prefetching -------------------------------------------------------
    def start(self) -> None:
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop = False

        def work():
            s = self.step
            while not self._stop:
                try:
                    self._q.put((s, self.batch_at(s)), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> np.ndarray:
        assert self._q is not None, "call start() first"
        s, b = self._q.get()
        self.step = s + 1
        return b

    def stop(self) -> None:
        self._stop = True
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None

    # ---- checkpoint hooks ---------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed, "shard": self.shard}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.seed and state["shard"] == self.shard
        self.step = int(state["step"])
