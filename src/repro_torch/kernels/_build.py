"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each source is compiled at first use into a shared library with a plain C
interface, under ``build/`` at the root of the checkout.  The library's
name carries a hash of the source, of the local headers it includes
(``#include "..."``, followed into headers that include others) and of the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  ``build_all`` starts one
nvcc per source, all at once, so the kernels of later sources build side by
side rather than one after another.  Nothing here runs at import time: this module imports on machines without
nvcc or a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "block_join": _CSRC / "block_join.cu",
    "cms_update": _CSRC / "cms_update.cu",
    "flash_attention": _CSRC / "flash_attention.cu",
    "flash_attention_bwd": _CSRC / "flash_attention_bwd.cu",
    "histogram": _CSRC / "histogram.cu",
    "ingest_fused": _CSRC / "ingest_fused.cu",
    "wkv6": _CSRC / "wkv6.cu",
    "wkv6_bwd": _CSRC / "wkv6_bwd.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled source: the loaded library and what its build said."""

    name: str
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an up-to-date library was reused
    ptxas: str  # the "-Xptxas -v" lines: registers, shared memory, spills


_loaded: dict[str, Built] = {}
_build_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(counts: dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``, a wrapper's launch count, atomically."""
    with _count_lock:
        counts[name] += 1


def reset_counts(counts: dict[str, int]) -> None:
    with _count_lock:
        for name in counts:
            counts[name] = 0


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(src: Path) -> list[Path]:
    """``src`` and every local header it includes, directly or through
    another header, each once, in the order first met."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _inputs(SOURCES[name]):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}_{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, Built]:
    """Compile (in parallel) and load every named source; returns them."""
    names = list(SOURCES) if names is None else list(names)
    if all(n in _loaded for n in names):  # every launch asks: no lock once loaded
        return {n: _loaded[n] for n in names}
    with _build_lock:
        return _build_locked(names)


def _build_locked(names: list[str]) -> dict[str, Built]:
    todo = [n for n in names if n not in _loaded]
    procs = {}
    for name in todo:
        out = _target(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            time.perf_counter(),
        )
    logs = {}
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n{log}")
        os.replace(tmp, _target(name))  # atomic: concurrent builders agree
        logs[name] = (seconds, log)
    for name in todo:
        seconds, log = logs.get(name, (0.0, ""))
        ptxas = "\n".join(
            line for line in log.splitlines() if re.search(r"ptxas|registers|spill", line)
        )
        path = _target(name)
        _loaded[name] = Built(name, ctypes.CDLL(str(path)), path, seconds, ptxas)
    return {n: _loaded[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built at first use."""
    return build_all([name])[name].lib
