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
    """Every repro_torch module imports with JAX unavailable (in a
    subprocess, so this worker's JAX stays intact)."""
    src = Path(__file__).resolve().parents[1] / "src"
    mods = sorted(
        ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(".__init__")
        for p in (src / "repro_torch").rglob("*.py")
    )
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
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
                "repro_torch.mapreduce.straggler"):
        assert mod in mods
    assert len(mods) >= 35
