"""Fault-tolerant checkpointing: atomic save, N-kept, async (the port of
``repro.train.checkpoint``).

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

``restore_tree`` rebuilds a tree of tensors shaped like a template from a
flat checkpoint, on a given device (where the JAX package takes
shardings); given the template's specs and a mesh, each rank takes its
block of every whole leaf, so a run resumes onto another mesh shape.  A
save of a model split over "model" gathers the whole leaves first
(``launch.sharding.gather_tree``), so the checkpoint is the JAX layout of
the whole model whatever the mesh.  ``AsyncCheckpointer`` copies the tree
to host numpy before its thread starts, so training may go on updating the
tensors in place while the thread writes.  A training state crosses between
the packages through
``models.convert`` (``train_state_to_jax_layout`` before a save,
``flat_from_jax_layout`` before a restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.launch.sharding import shard_slices


def _to_numpy(x: Any) -> np.ndarray:
    """A leaf as host numpy: tensors are copied off their device."""
    if isinstance(x, torch.Tensor):  # a copy: the caller may update x in place
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> dict[str, np.ndarray]:
    """Leaves of ``tree`` by ``/``-joined path, in JAX's flattening order."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {"/".join(str(p) for p in prefix): _to_numpy(tree)}
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


def restore_tree(template: Any, flat: dict[str, np.ndarray], device=None, specs: Any = None,
                 mesh=None) -> Any:
    """A tree shaped like ``template`` (dicts, lists, tuples, ``None``; tensor
    or array leaves) from a flat checkpoint, each leaf a tensor of the
    template leaf's dtype on ``device`` (default: the template leaf's
    device).  Keys are the template's paths; a missing key or a shape that
    differs raises, as in the JAX package.  With ``specs`` (a spec a
    template leaf, ``launch.sharding``) and ``mesh``, each checkpoint leaf
    is whole and this rank keeps its block of it."""

    def build(node, prefix: tuple, spec):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], prefix + (k,), spec and spec[k]) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub, prefix + (i,), spec and spec[i])
                              for i, sub in enumerate(node))
        key = "/".join(str(p) for p in prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = np.asarray(flat[key])
        if spec:
            arr = arr[shard_slices(arr.shape, spec, mesh)]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"{key}: ckpt shape {arr.shape} != model {tuple(node.shape)}")
        like = node if isinstance(node, torch.Tensor) else torch.from_numpy(np.asarray(node))
        dev = like.device if device is None else torch.device(device)
        host = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))  # 0-d stays 0-d
        return host.to(device=dev, dtype=like.dtype)

    return build(template, (), specs)


class AsyncCheckpointer:
    """One-in-flight background saver with back-pressure: ``save`` waits for
    the previous save, copies the tree to host numpy, then writes it on a
    thread; ``wait`` joins it and raises what it raised."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = _flatten_with_paths(tree)  # snapshot (host copies) before async

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

