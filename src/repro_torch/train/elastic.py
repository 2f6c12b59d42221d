"""Elastic scaling + preemption handling (DESIGN.md §5): the port of
``repro.train.elastic``.

  * ``plan_mesh_shape`` — given surviving chip count and the model-parallel
    degree (fixed by the weight layout), pick the largest usable (pods,
    data, model) shape and report chips left idle.  The streaming engine's
    degraded recovery sizes its repaired grid with it.
  * ``PreemptionGuard`` — SIGTERM flips a flag; the loop checkpoints and
    exits cleanly at the next step (or micro-batch) boundary.
  * ``run_elastic_loop`` — a train loop with periodic and preemption
    checkpoints.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int
    chips_used: int
    chips_idle: int


def plan_mesh_shape(
    healthy_chips: int,
    model_parallel: int,
    chips_per_pod: int = 256,
    min_data: int = 1,
) -> MeshPlan:
    """Largest (pods, data, model) grid with the required model-parallel
    degree.  data is per-pod; pods = full healthy pods (partial pods fold
    into a single-pod remainder mesh if they still fit model_parallel)."""
    if healthy_chips < model_parallel * min_data:
        raise ValueError(
            f"{healthy_chips} chips cannot host model_parallel={model_parallel}"
        )
    pods = healthy_chips // chips_per_pod
    if pods >= 1:
        per_pod_data = chips_per_pod // model_parallel
        used = pods * per_pod_data * model_parallel
        return MeshPlan(pods, per_pod_data, model_parallel, used, healthy_chips - used)
    data = healthy_chips // model_parallel
    used = data * model_parallel
    return MeshPlan(1, data, model_parallel, used, healthy_chips - used)


class PreemptionGuard:
    """Installs a SIGTERM/SIGINT handler that requests a clean stop."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._signals = signals
        self._old: dict = {}

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, h in self._old.items():
            signal.signal(s, h)

    def _handler(self, signum, frame) -> None:
        self._requested = True

    @property
    def should_stop(self) -> bool:
        return self._requested


def run_elastic_loop(
    steps: int,
    step_fn: Callable[[int], dict],
    save_fn: Callable[[int], None],
    checkpoint_every: int = 50,
    guard: PreemptionGuard | None = None,
) -> int:
    """Drive a train loop with periodic + preemption checkpoints.
    Returns the last completed step."""
    last = -1
    for step in range(steps):
        step_fn(step)
        last = step
        if guard is not None and guard.should_stop:
            save_fn(step)
            break
        if checkpoint_every and (step + 1) % checkpoint_every == 0:
            save_fn(step)
    return last
