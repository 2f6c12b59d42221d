"""Training substrate: optimizer, train step, checkpointing, elasticity and
the cross-pod gradient compression (the port of ``repro.train``)."""
from .checkpoint import (
    AsyncCheckpointer,
    latest_step,
    load_checkpoint,
    load_manifest,
    restore_tree,
    save_checkpoint,
    tenant_checkpoint_dir,
)
from .compression import (
    compressed_psum,
    compressed_tree_psum,
    dequantize,
    init_residuals,
    quantize,
)
from .elastic import MeshPlan, PreemptionGuard, plan_mesh_shape, run_elastic_loop
from .optimizer import OptConfig, adamw_update, init_opt_state, schedule
from .train_step import init_train_state, make_train_step

__all__ = [
    "AsyncCheckpointer",
    "MeshPlan",
    "OptConfig",
    "PreemptionGuard",
    "adamw_update",
    "compressed_psum",
    "compressed_tree_psum",
    "dequantize",
    "init_opt_state",
    "init_residuals",
    "init_train_state",
    "latest_step",
    "load_checkpoint",
    "load_manifest",
    "make_train_step",
    "plan_mesh_shape",
    "quantize",
    "restore_tree",
    "run_elastic_loop",
    "save_checkpoint",
    "schedule",
    "tenant_checkpoint_dir",
]
