"""Card-only tests: the CUDA kernels against their plain versions, and the
port's join on the card against its own CPU run.  They carry the ``gpu``
marker and skip where no card is present; on a machine with one, run
``python -m pytest -m gpu tests/test_torch_gpu.py``.  This file imports no
JAX, so it runs where JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch import mapreduce as tmr
from repro_torch.kernels import block_join as bj

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "k,cap_r,cap_s,c",
    [(1, 8, 8, 1), (4, 32, 16, 1), (3, 600, 700, 2), (8, 128, 2100, 3), (5, 1000, 3, 1)],
)
def test_reducer_join_kernel_matches_plain(cuda, k, cap_r, cap_s, c):
    rng = np.random.default_rng(k + cap_r + cap_s + c)
    ops = [
        rng.integers(0, 6, (k, cap_r, c)), rng.integers(-2, 5, (k, cap_r)),
        rng.integers(0, 6, (k, cap_s, c)), rng.integers(-2, 5, (k, cap_s)),
    ]
    ops = [torch.from_numpy(o.astype(np.int32)).to(cuda) for o in ops]
    before = bj.LAUNCHES["reducer_join"]
    got = bj.reducer_join(*ops)
    torch.cuda.synchronize()
    assert bj.LAUNCHES["reducer_join"] == before + 1
    want = bj.block_join_ref(*ops)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flat_join_kernel_wraparound(cuda):
    n = 5000
    keys = torch.zeros((n, 1), dtype=torch.int32, device=cuda)
    w = torch.full((n,), 40_000, dtype=torch.int32, device=cuda)
    cnt, chk = bj.flat_join(keys, w, keys, w)
    assert int(cnt) == n * n
    assert int(chk) & 0xFFFFFFFF == (40_000 * 40_000 * n * n) % (1 << 32)


@pytest.mark.parametrize("name", ["2way", "3way"])
def test_run_join_on_card_matches_cpu(cuda, name):
    rng = np.random.default_rng(0)
    if name == "2way":
        query, data, q = tcore.two_way(), tdata.paper_2way(rng, 20_000, 2_000, 30_000), 100
    else:
        query, data, q = tcore.three_way_paper(), tdata.paper_3way(rng, 2_000, 20_000), 120
    plan = tcore.plan_shares_skew(query, data, q=q)
    got = tmr.run_join(query, data, plan, cap_factor=5.0, device=cuda)
    want = tmr.run_join(query, data, plan, cap_factor=5.0, device="cpu")
    assert (got.count, got.checksum, got.overflow) == (want.count, want.checksum, 0)
    assert got.comm_tuples == want.comm_tuples
    np.testing.assert_array_equal(got.reducer_loads, want.reducer_loads)
    assert (got.count, got.checksum) == tmr.oracle_join(query, data)[:2]
