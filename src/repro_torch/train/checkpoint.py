"""Fault-tolerant checkpointing: atomic save, N-kept (the port of
``repro.train.checkpoint``'s save and load half).

Layout:  <dir>/step_<N>/
             manifest.json   (step, keys, shapes, dtypes, time, metadata)
             arrays.npz      (flattened leaves keyed by path)
         <dir>/LATEST        (atomic pointer file)

Writes go to a temp dir then ``os.replace`` (atomic on POSIX), so a host
dying mid-save can never corrupt the latest checkpoint.  The layout and the
keys are the JAX package's, so either package reads the other's arrays:
a tree is flattened as ``jax.tree_util.tree_flatten_with_path`` flattens
it — dicts by sorted key, lists and tuples by index, ``None`` an empty
subtree — and a leaf's key is its path joined by ``/``.

``restore_tree`` and ``AsyncCheckpointer`` serve training and wait for it
(ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> dict[str, np.ndarray]:
    """Leaves of ``tree`` by ``/``-joined path, in JAX's flattening order."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {"/".join(str(p) for p in prefix): np.asarray(tree)}
    flat: dict[str, np.ndarray] = {}
    for key, sub in items:
        flat.update(_flatten_with_paths(sub, prefix + (key,)))
    return flat


def tenant_checkpoint_dir(directory: str, tenant: str) -> str:
    """Per-tenant namespaced sub-directory under a shared checkpoint root.

    A multi-tenant engine (DESIGN.md §9) checkpoints every tenant's engine
    independently — same atomic step/LATEST layout, one namespace per
    query — so kill → resume restores each tenant bit-identically and a
    corrupt save in one namespace can never touch a neighbor's.  Tenant
    names are restricted to filename-safe tokens so a query id can't
    escape the root (``../``) or collide with the ``step_``/``LATEST``
    entries of a non-namespaced checkpoint.
    """
    if not tenant or not all(c.isalnum() or c in "-_." for c in tenant):
        raise ValueError(
            f"tenant name {tenant!r} is not filename-safe "
            "(alphanumerics, '-', '_', '.' only)"
        )
    if tenant.startswith(("step_", ".")) or tenant == "LATEST":
        raise ValueError(f"tenant name {tenant!r} is reserved")
    return os.path.join(directory, f"tenant_{tenant}")


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    keep: int = 3,
    metadata: dict | None = None,
) -> str:
    """``metadata``: optional JSON-able dict stored in the manifest —
    consumers (e.g. the streaming engine checkpoint, DESIGN.md §8) use it
    for format versions and non-array scalars that must survive restore."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten_with_paths(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "time": time.time(),
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic
    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def load_checkpoint(directory: str, step: int | None = None) -> tuple[int, dict[str, np.ndarray]]:
    """Returns (step, flat path->array dict)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return step, flat


def load_manifest(directory: str, step: int | None = None) -> dict:
    """The manifest (incl. ``metadata``) of one checkpoint step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)
