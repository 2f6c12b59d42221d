"""Which ``torch.distributed`` process group carries a tensor.

Shared by the distributed shuffle (``mapreduce.shuffle``) and the gradient
compression (``train.compression``).  The group is the caller's, the
default group when ``torch.distributed`` is initialized, or else a one-rank
group of this process (``one_rank_group``): NCCL for a CUDA device, gloo for
the CPU.  A gloo group does not take CUDA tensors here, nor NCCL CPU
tensors: a mismatch raises rather than switching backends.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

_ONE_RANK: dict[str, dist.ProcessGroup] = {}  # backend -> this process's one-rank group


def one_rank_group(backend: str) -> dist.ProcessGroup:
    """A process group of this process alone on ``backend`` ("gloo" or
    "nccl"), on a private ``FileStore`` whose directory goes at exit; built
    once per backend and kept.  It is not the default group, so
    ``torch.distributed`` stays uninitialized for other code.

    It is put together with ``ProcessGroup``'s private ``_set_default_backend``
    and ``_register_backend``, the way ``init_process_group`` builds its
    own; ``tests/test_torch_shuffle.py`` fails if they change."""
    if backend not in _ONE_RANK:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"no one-rank group for backend {backend!r}")
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL")
        root = tempfile.mkdtemp(prefix="repro_pg_")
        store = dist.FileStore(os.path.join(root, "store"), 1)
        if backend == "gloo":
            impl, device = dist.ProcessGroupGloo(store, 0, 1), "cpu"
        else:
            impl, device = dist.ProcessGroupNCCL(store, 0, 1), "cuda"
        kind = getattr(dist.ProcessGroup.BackendType, backend.upper())
        group = dist.ProcessGroup(store, 0, 1)
        group._set_default_backend(kind)
        group._register_backend(torch.device(device), kind, impl)
        atexit.register(_close, group, root)
        _ONE_RANK[backend] = group
    return _ONE_RANK[backend]


def _close(group: dist.ProcessGroup, root: str) -> None:
    """Shut ``group`` down, then remove its store's directory.  In this
    order: NCCL's heartbeat monitor reads the store until its group is shut
    down, and a store gone from under it holds the process at exit."""
    group.shutdown()
    shutil.rmtree(root, ignore_errors=True)


def resolve_group(group: dist.ProcessGroup | None, dev: torch.device) -> dist.ProcessGroup:
    """``group``, or the default group when ``torch.distributed`` is
    initialized, or this process's one-rank group for ``dev``'s type.
    Raises where the group's backend cannot carry ``dev``'s tensors."""
    if group is None:
        if dist.is_initialized():
            group = dist.group.WORLD
        else:
            group = one_rank_group("nccl" if dev.type == "cuda" else "gloo")
    backend = group.name()
    if backend == "gloo" and dev.type == "cuda":
        raise ValueError("a gloo group does not carry CUDA tensors here: use NCCL on the card")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group carries CUDA tensors only: use gloo on the CPU")
    return group


def rank_device(dev: torch.device, group: dist.ProcessGroup) -> torch.device:
    """``dev``; for an unindexed CUDA device on a group of several ranks,
    ``cuda:{LOCAL_RANK}``.  Raises when ``LOCAL_RANK`` is unset there: which
    card a rank owns is the launcher's to say, not a guess from the rank."""
    if dev.type != "cuda" or dev.index is not None or group.size() == 1:
        return dev
    if "LOCAL_RANK" not in os.environ:
        raise RuntimeError(
            f"rank {group.rank()} of {group.size()} on an unindexed CUDA device and LOCAL_RANK "
            "is unset: pass device='cuda:<n>' or launch with torchrun")
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
