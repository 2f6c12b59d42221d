"""Which ``torch.distributed`` process group carries a tensor.

Shared by the distributed shuffle (``mapreduce.shuffle``) and the gradient
compression (``train.compression``).  The group is the caller's, the
default group when ``torch.distributed`` is initialized, or else a one-rank
group of this process (``one_rank_group``): NCCL for a CUDA device, gloo for
the CPU.  A gloo group does not take CUDA tensors here, nor NCCL CPU
tensors: a mismatch raises rather than switching backends.  A launcher
starts the default group with ``world``: from ``torchrun``'s environment, or
as a world of this process alone.
"""
from __future__ import annotations

import atexit
import contextlib
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


@contextlib.contextmanager
def world(device: torch.device | str):
    """The default process group for a launcher, for the ``with``
    block: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) when ``WORLD_SIZE`` is set, else a
    world of this process alone on a private ``FileStore``; NCCL for CUDA,
    gloo for the CPU.  Yields (group, this rank's device: ``rank_device``,
    with its index on the card, made current there).  A default group the
    caller started is used as it is and left running; one started here is
    destroyed on the way out, then its store's directory removed."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    root = None
    started = not dist.is_initialized()
    try:
        if started and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        elif started:
            root = tempfile.mkdtemp(prefix="repro_world_")
            dist.init_process_group(backend, rank=0, world_size=1,
                                    store=dist.FileStore(os.path.join(root, "store"), 1))
        group = resolve_group(None, dev)
        dev = rank_device(dev, group)
        if dev.type == "cuda":
            if dev.index is None:  # a world of one: the current card
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        yield group, dev
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
