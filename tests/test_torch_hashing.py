"""The torch port's hashes against the JAX package's, bit for bit, and the
port's import isolation from JAX."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mapreduce import hashing as ref
from repro_torch.mapreduce import hashing as port

_I32 = np.iinfo(np.int32)
_SEEDS = [0, 1, 0x5EED, (1 << 31) - 1, 1 << 31, (1 << 31) + 12345, (1 << 32) - 2]


def _int32_values(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    edge = np.array([_I32.min, _I32.min + 1, -65537, -65536, -1, 0, 1, 65535,
                     65536, _I32.max - 1, _I32.max], dtype=np.int32)
    return np.concatenate([edge, rng.integers(_I32.min, _I32.max, n, dtype=np.int64,
                                              endpoint=True).astype(np.int32)])


@pytest.mark.parametrize("seed", _SEEDS)
def test_mix32_full_int32_range(seed):
    x = _int32_values(seed=seed & 0xFFFF)
    want = np.asarray(ref.mix32_jnp(jnp.asarray(x), seed))
    np.testing.assert_array_equal(port.mix32_np(x, seed), want)
    np.testing.assert_array_equal(ref.mix32_np(x, seed), want)
    got = port.mix32_torch(torch.from_numpy(x), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dim", [1, 3, 200, 990, (1 << 31) - 1])
def test_bucket_matches_reference(dim):
    x = _int32_values(seed=dim % 1000)
    seed = ref.attr_seed(1, "B")
    want = np.asarray(ref.bucket_jnp(jnp.asarray(x), seed, dim))
    np.testing.assert_array_equal(port.bucket_torch(torch.from_numpy(x), seed, dim).numpy(), want)
    np.testing.assert_array_equal(port.bucket_np(x, seed, dim), want)


def test_bucket_accepts_int64_rows_as_their_int32_pattern():
    # the executors wrap int64 inputs to int32 before hashing
    x64 = np.array([-(1 << 40) - 3, (1 << 33) + 5, -1, 7], dtype=np.int64)
    want = np.asarray(ref.bucket_jnp(jnp.asarray(x64.astype(np.int32)), 99, 1000))
    np.testing.assert_array_equal(port.bucket_torch(torch.from_numpy(x64), 99, 1000).numpy(), want)


@pytest.mark.parametrize("arity", [1, 2, 3])
@pytest.mark.parametrize("seed", [0x5EED, 0x5EED + 2, (1 << 31) + 7])
def test_row_weight_matches_reference(arity, seed):
    rng = np.random.default_rng(arity)
    rows = rng.integers(_I32.min, _I32.max, (5_000, arity), dtype=np.int64).astype(np.int32)
    rows[:4] = [[_I32.min] * arity, [_I32.max] * arity, [-1] * arity, [0] * arity]
    want = np.asarray(ref.row_weight_jnp(jnp.asarray(rows), seed))
    np.testing.assert_array_equal(ref.row_weight_np(rows, seed), want)
    np.testing.assert_array_equal(port.row_weight_np(rows, seed), want)
    got = port.row_weight_torch(torch.from_numpy(rows), seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_attr_seed_matches_reference():
    for ridx in range(5):
        for attr in ("A", "B", "X1", "long_name"):
            assert port.attr_seed(ridx, attr) == ref.attr_seed(ridx, attr)


def test_row_weight_rejects_mod_below_one():
    # weight 0 marks an invalid slot in the block join, so a valid row's
    # weight must be >= 1, which h % mod + 1 guarantees only for mod >= 1
    rows = torch.zeros((3, 2), dtype=torch.int32)
    for bad in (0, -5):
        with pytest.raises(ValueError, match="mod >= 1"):
            port.row_weight_torch(rows, 1, mod=bad)
        with pytest.raises(ValueError, match="mod >= 1"):
            port.row_weight_np(rows.numpy(), 1, mod=bad)
    assert torch.equal(port.row_weight_torch(rows, 1, mod=1), torch.ones(3, dtype=torch.int32))


def test_port_imports_with_jax_blocked():
    """Every repro_torch module, and each of the port's examples, imports
    with JAX unavailable and loads no ``repro`` module (in a subprocess, so
    this worker's JAX stays intact)."""
    src = Path(__file__).resolve().parents[1] / "src"
    examples = sorted(str(p) for p in (src.parent / "examples").glob("*_torch.py"))
    mods = sorted(
        ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(".__init__")
        for p in (src / "repro_torch").rglob("*.py")
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib, importlib.util\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for path in {examples!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n"
        "print('ok', len(" + repr(mods) + "))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(src)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    for mod in ("repro_torch.kernels.block_join", "repro_torch.kernels.ingest_fused",
                "repro_torch.kernels.sketch_update", "repro_torch.stream.engine",
                "repro_torch.stream.sketch", "repro_torch.obs.trace",
                "repro_torch.mapreduce.straggler", "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.histogram", "repro_torch.configs.base",
                "repro_torch.configs.olmo_1b", "repro_torch.models.layers",
                "repro_torch.models.transformer", "repro_torch.models.zoo",
                "repro_torch.models.convert", "repro_torch.serve.engine",
                "repro_torch.core.closed_forms", "repro_torch.testing.faults",
                "repro_torch.train.checkpoint", "repro_torch.train.elastic",
                "repro_torch.stream.tenancy", "repro_torch.mapreduce.shuffle",
                "repro_torch.train.compression", "repro_torch.models.mamba2",
                "repro_torch.distributed", "repro_torch.launch", "repro_torch.launch.mesh",
                "repro_torch.launch.sharding", "repro_torch.launch.train",
                "repro_torch.launch.dryrun", "repro_torch.kernels.wkv6"):
        assert mod in mods
    assert {Path(p).name for p in examples} >= {
        "quickstart_torch.py", "serve_lm_torch.py", "streaming_join_torch.py",
        "multiway_join_torch.py"}
    assert len(mods) >= 60


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/expert_parallel.py",
                                    "tools/launcher_split.py", "tools/recurrent_precision.py",
                                    "tools/tensor_parallel.py"])
def test_chip_scripts_import_with_jax_blocked(script):
    """The scripts that drive the port on cards import with JAX unavailable
    and load no ``repro`` module (in a subprocess)."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\n"
        f"spec = importlib.util.spec_from_file_location('script', {str(root / script)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
