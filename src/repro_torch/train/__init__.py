"""What the streaming engine needs of the training substrate: atomic
checkpoints and elastic mesh planning with preemption handling (the port
of part of ``repro.train``).  The optimizer, the train step, gradient
compression, ``run_elastic_loop``, ``restore_tree`` and
``AsyncCheckpointer`` wait for training (ROADMAP.md queue 1 item 14)."""
from .checkpoint import (
    latest_step,
    load_checkpoint,
    load_manifest,
    save_checkpoint,
    tenant_checkpoint_dir,
)
from .elastic import MeshPlan, PreemptionGuard, plan_mesh_shape

__all__ = [
    "MeshPlan",
    "PreemptionGuard",
    "latest_step",
    "load_checkpoint",
    "load_manifest",
    "plan_mesh_shape",
    "save_checkpoint",
    "tenant_checkpoint_dir",
]
