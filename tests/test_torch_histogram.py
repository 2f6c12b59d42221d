"""The port's histogram (K5) plain version against the JAX package's Pallas
kernel (interpret mode on the CPU), bit for bit, on the same seeded inputs;
the wrapper's checks.  The CUDA kernel itself is held against the plain
version in ``tests/test_torch_gpu.py`` on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import histogram as jax_histogram
from repro.kernels.ref import histogram_ref as jax_histogram_ref
from repro_torch.kernels import histogram as hg


@pytest.mark.parametrize("n", [1, 7, 256, 1000, 4096])
@pytest.mark.parametrize("num_bins", [4, 64, 513])
def test_plain_matches_pallas(n, num_bins):
    """tests/test_kernels.py's shapes: values in [-1, num_bins)."""
    rng = np.random.default_rng(n * 1000 + num_bins)
    vals = rng.integers(-1, num_bins, size=n).astype(np.int32)
    got = hg.histogram(torch.from_numpy(vals), num_bins)
    assert got.dtype == torch.int32 and got.shape == (num_bins,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histogram(jnp.asarray(vals),
                                                                        num_bins)))


def test_values_past_the_last_bin_are_dropped_as_the_pallas_kernel_drops_them():
    """The Pallas kernel's one-hot against iota [0, num_bins) drops values
    >= num_bins; the jnp oracle clips them into the last bin.  The port
    follows the kernel."""
    rng = np.random.default_rng(5)
    vals = rng.integers(-5, 80, size=3000).astype(np.int32)
    vals[:3] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, 64]
    got = hg.histogram(torch.from_numpy(vals), 64).numpy()
    pallas = np.asarray(jax_histogram(jnp.asarray(vals), 64))
    oracle = np.asarray(jax_histogram_ref(jnp.asarray(vals), 64))
    np.testing.assert_array_equal(got, pallas)
    in_range = (vals >= 0) & (vals < 64)
    assert got.sum() == in_range.sum()
    past = int((vals >= 64).sum())
    assert past > 0
    assert oracle[-1] == got[-1] + past
    np.testing.assert_array_equal(oracle[:-1], got[:-1])


def test_empty_and_single_bin():
    assert torch.equal(hg.histogram(torch.zeros(0, dtype=torch.int32), 3),
                       torch.zeros(3, dtype=torch.int32))
    vals = torch.tensor([0, 0, -1, 1, 5], dtype=torch.int32)
    assert hg.histogram(vals, 1).tolist() == [2]


def test_heavy_hitter_count_of_a_join_column():
    """The heavy-hitter frequency count the planner takes in numpy
    (``core.heavy_hitters``), here over a §9.1 R join column at CPU size."""
    from repro_torch.data import paper_2way

    r = paper_2way(np.random.default_rng(0), n_r=20_000, n_s=2_000)["R"]
    col = r[:, 1]
    got = hg.histogram(torch.from_numpy(col.astype(np.int32)), 100_000).numpy()
    np.testing.assert_array_equal(got, np.bincount(col, minlength=100_000))
    assert int(got.argmax()) == 7


@pytest.mark.parametrize(
    "values,num_bins,err",
    [
        (torch.zeros(4, dtype=torch.int64), 8, TypeError),
        (torch.zeros((2, 2), dtype=torch.int32), 8, ValueError),
        (torch.zeros(4, dtype=torch.int32), 0, ValueError),
    ],
)
def test_wrapper_rejects(values, num_bins, err):
    with pytest.raises(err):
        hg.histogram(values, num_bins)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    hg.reset_launches()
    hg.histogram(torch.arange(10, dtype=torch.int32), 5)
    assert hg.LAUNCHES["histogram"] == 0
