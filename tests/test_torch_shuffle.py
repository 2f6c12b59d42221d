"""The port's distributed shuffle (``repro_torch.mapreduce.run_distributed``)
and the engine's ``recompute_distributed`` against the JAX package's, on
the CPU.

Four gloo processes (initialized from a file store, each a Python process
of its own) run the port, and the JAX package runs on four host devices
forced in a subprocess of its own, as ``tests/test_mapreduce.py`` runs its
eight: count, checksum, ``comm_tuples``, ``reducer_loads`` and
``overflow`` are equal bit for bit, in a case whose send buffers overflow
too.  At world one the port runs on this process's one-rank gloo group."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import core as jcore
from repro import mapreduce as jmr
from repro import stream as jstream
from repro.data import paper_2way as jax_paper_2way
from repro_torch import core as tcore
from repro_torch import distributed as tdist
from repro_torch import mapreduce as tmr
from repro_torch import stream as tstream
from repro_torch.data import paper_2way, paper_3way
from torch_cases import gloo_ranks_and_jax

_WORLD = 4

# the cases of tests/test_mapreduce.py's distributed test, and a 2-way one
# whose send buffers are too small: built alike from either package
_CASES = r"""
import numpy as np
from {pkg}.core import plan_shares_skew, two_way, three_way_paper
from {pkg}.data import paper_2way, paper_3way

def cases():
    data = paper_2way(np.random.default_rng(0), n_r=3000, n_s=600, domain=2000)
    plan = plan_shares_skew(two_way(), data, q=200)
    data3 = paper_3way(np.random.default_rng(2), n=400, domain=300)
    plan3 = plan_shares_skew(three_way_paper(), data3, q=150)
    return [
        ("2way", two_way(), data, plan, dict(cap_factor=4.0, route_cap_factor=4.0)),
        ("3way", three_way_paper(), data3, plan3, dict(cap_factor=4.0, route_cap_factor=4.0)),
        ("2way_overflow", two_way(), data, plan, dict(cap_factor=4.0, route_cap_factor=0.3)),
    ]

def record(res):
    return dict(count=res.count, checksum=res.checksum, comm=res.comm_tuples,
                loads=[int(x) for x in res.reducer_loads], overflow=res.overflow)
"""

_JAX_SNIPPET = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro.mapreduce import run_distributed
{cases}
assert len(jax.devices()) == {world}
out = {{name: record(run_distributed(q, d, p, **kw)) for name, q, d, p, kw in cases()}}
print("RESULT " + json.dumps(out))
"""

_PORT_SNIPPET = r"""
import json, sys
sys.modules["jax"] = None  # the port runs without JAX
import torch.distributed as dist
from repro_torch.mapreduce import run_distributed
{cases}
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
out = {{name: record(run_distributed(q, d, p, device="cpu", **kw))
       for name, q, d, p, kw in cases()}}
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def test_four_gloo_ranks_equal_jax_on_four_devices():
    """The port on 4 gloo processes against the JAX package on 4 forced
    host devices, every field bit for bit; each rank returns the same
    result; the third case overflows its send buffers."""
    got, want = gloo_ranks_and_jax(_PORT_SNIPPET.format(cases=_CASES.format(pkg="repro_torch")),
                                   _JAX_SNIPPET.format(world=_WORLD,
                                                       cases=_CASES.format(pkg="repro")),
                                   _WORLD)
    assert sorted(want) == ["2way", "2way_overflow", "3way"]
    for rank_out in got:
        assert rank_out == want
    assert want["2way"]["overflow"] == 0 and want["3way"]["overflow"] == 0
    assert want["2way_overflow"]["overflow"] > 0
    assert want["2way_overflow"]["count"] < want["2way"]["count"]


# ------------------------------------------------------------- world one
def _world_one_cases():
    data = paper_2way(np.random.default_rng(8), n_r=2000, n_s=400, domain=1500)
    data3 = paper_3way(np.random.default_rng(2), n=300, domain=200)
    return [(tcore.two_way(), data, 200), (tcore.three_way_paper(), data3, 150)]


@pytest.mark.parametrize("case", [0, 1])
def test_world_one_matches_oracle_and_run_join(case):
    """On this process's one-rank gloo group (``torch.distributed`` stays
    uninitialized): the oracle's count and checksum, and ``run_join``'s
    comm and loads, as ``tests/test_mapreduce.py`` holds the JAX package."""
    query, data, q = _world_one_cases()[case]
    plan = tcore.plan_shares_skew(query, data, q=q)
    res = tmr.run_distributed(query, data, plan, cap_factor=4.0, device="cpu")
    count, checksum, _, _ = tmr.oracle_join(query, data)
    ref = tmr.run_join(query, data, plan, cap_factor=4.0, device="cpu")
    assert res.overflow == 0
    assert (res.count, res.checksum) == (count, checksum)
    assert res.comm_tuples == ref.comm_tuples == tmr.predicted_comm(plan)
    np.testing.assert_array_equal(res.reducer_loads, ref.reducer_loads)
    assert not dist.is_initialized()


def test_world_one_equals_jax_world_one():
    """The same call in both packages at world one, every field."""
    data = paper_2way(np.random.default_rng(8), n_r=2000, n_s=400, domain=1500)
    plan = tcore.plan_shares_skew(tcore.two_way(), data, q=200)
    jplan = jcore.plan_shares_skew(jcore.two_way(), data, q=200)
    for kw in (dict(cap_factor=4.0), dict(cap_factor=1.0, route_cap_factor=0.2)):
        got = tmr.run_distributed(tcore.two_way(), data, plan, device="cpu", **kw)
        want = jmr.run_distributed(jcore.two_way(), data, jplan, **kw)
        assert (got.count, got.checksum, got.comm_tuples, got.overflow) == (
            want.count, want.checksum, want.comm_tuples, want.overflow)
        np.testing.assert_array_equal(got.reducer_loads, want.reducer_loads)


def test_empty_relation_returns_an_empty_join():
    data = {"R": np.zeros((0, 2), np.int64), "S": np.ones((5, 2), np.int64)}
    plan = tcore.plan_shares_skew(tcore.two_way(), data, q=10)
    res = tmr.run_distributed(tcore.two_way(), data, plan, device="cpu")
    assert (res.count, res.checksum, res.overflow, res.reducer_loads.size) == (0, 0, 0, 0)
    assert res.comm_tuples == {"R": 0, "S": 0}


def test_groups_refuse_tensors_they_cannot_carry():
    """No silent switch between gloo and NCCL: a gloo group refuses a CUDA
    device, an NCCL group the CPU, and a CUDA device without a card raises
    before any group is built."""
    gloo = tdist.one_rank_group("gloo")
    assert tdist.one_rank_group("gloo") is gloo  # built once
    assert tdist.resolve_group(None, torch.device("cpu")) is gloo
    with pytest.raises(ValueError, match="gloo"):
        tdist.resolve_group(gloo, torch.device("cuda"))

    class _Nccl:
        def name(self):
            return "nccl"

    with pytest.raises(ValueError, match="NCCL"):
        tdist.resolve_group(_Nccl(), torch.device("cpu"))
    data = paper_2way(np.random.default_rng(1), n_r=100, n_s=20, domain=50)
    plan = tcore.plan_shares_skew(tcore.two_way(), data, q=50)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmr.run_distributed(tcore.two_way(), data, plan)



def test_one_rank_group_is_a_working_gloo_group():
    """``one_rank_group`` is built through ``ProcessGroup``'s private
    backend registration: a change there shows here, as a group of the
    wrong name or size, or one whose collective does not run."""
    gloo = tdist.one_rank_group("gloo")
    assert (gloo.name(), gloo.size(), gloo.rank()) == ("gloo", 1, 0)
    assert not dist.is_initialized()
    x = torch.arange(5, dtype=torch.int64)
    dist.all_reduce(x, group=gloo)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=gloo)
    assert torch.equal(out, torch.arange(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="no one-rank group"):
        tdist.one_rank_group("mpi")


def test_one_rank_group_store_goes_at_exit(tmp_path):
    """The one-rank group's ``FileStore`` directory is removed when the
    process exits."""
    code = (
        "import glob, os, tempfile\n"
        "from repro_torch.distributed import one_rank_group\n"
        "one_rank_group('gloo')\n"
        "print(*glob.glob(os.path.join(tempfile.gettempdir(), 'repro_pg_*')))\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(src),
                                           "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    made = out.stdout.split()
    assert len(made) == 1 and made[0].startswith(str(tmp_path))
    assert not os.path.exists(made[0])


def test_rank_device_needs_local_rank_at_world_above_one(monkeypatch):
    """At world > 1 an unindexed CUDA device becomes ``cuda:{LOCAL_RANK}``;
    with ``LOCAL_RANK`` unset it raises rather than guess a card."""

    class _Two:
        def size(self):
            return 2

        def rank(self):
            return 1

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK is unset"):
        tdist.rank_device(cuda, _Two())
    assert tdist.rank_device(torch.device("cuda", 3), _Two()) == torch.device("cuda", 3)
    assert tdist.rank_device(cpu, _Two()) == cpu
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdist.rank_device(cuda, _Two()) == torch.device("cuda", 1)
    assert tdist.rank_device(cuda, tdist.one_rank_group("gloo")) == cuda

# ------------------------------------------------ the engine's recompute
def _zipf_batch(rng, shift, n_r=240, n_s=80, domain=600, a=1.6):
    """tests/test_stream_bounded.py's small 2-way batch."""
    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _engines(cfg_kw: dict, batches):
    """A port engine on the CPU and a JAX engine, each fed ``batches``."""
    port = tstream.StreamingJoinEngine(tcore.two_way(), tstream.StreamConfig(**cfg_kw),
                                       device="cpu")
    ref = jstream.StreamingJoinEngine(jcore.two_way(), jstream.StreamConfig(**cfg_kw))
    for batch in batches:
        assert port.ingest(batch).batch == ref.ingest(batch).batch
    return port, ref


def _same(got, want):
    assert (got.count, got.checksum, got.comm_tuples, got.overflow) == (
        want.count, want.checksum, want.comm_tuples, want.overflow)
    np.testing.assert_array_equal(got.reducer_loads, want.reducer_loads)


def test_recompute_distributed_agrees_with_jax_engine():
    """``tests/test_stream.py::test_engine_distributed_recompute_agrees``:
    the replay equals the cumulative fingerprint, and the JAX engine's
    replay field by field."""
    rng = np.random.default_rng(16)
    batches = [jax_paper_2way(rng, n_r=500, n_s=150, domain=900) for _ in range(2)]
    port, ref = _engines(dict(q=150), batches)
    with pytest.raises(RuntimeError, match="no batches"):
        tstream.StreamingJoinEngine(tcore.two_way(), tstream.StreamConfig(q=150),
                                    device="cpu").recompute_distributed()
    got = port.recompute_distributed(cap_factor=8.0, route_cap_factor=8.0)
    want = ref.recompute_distributed(cap_factor=8.0, route_cap_factor=8.0)
    assert got.overflow == 0
    assert (got.count, got.checksum) == (port.total_count, port.total_checksum)
    _same(got, want)


def test_recompute_refuses_after_expiry_as_jax_does():
    """``tests/test_stream_bounded.py:118-119``: with batches expired the
    replay refuses unless ``window=True``, then equals the window
    fingerprint and the JAX engine's replay."""
    rng = np.random.default_rng(3)
    cfg = dict(q=60, decay=0.5, load_factor=2.0)
    port = tstream.StreamingJoinEngine(tcore.two_way(), tstream.StreamConfig(
        **cfg, retention=tstream.RetentionPolicy(window_batches=2)), device="cpu")
    ref = jstream.StreamingJoinEngine(jcore.two_way(), jstream.StreamConfig(
        **cfg, retention=jstream.RetentionPolicy(window_batches=2)))
    for _ in range(5):
        batch = _zipf_batch(rng, 0)
        port.ingest(batch)
        ref.ingest(batch)
    assert port.expired_batches == ref.expired_batches > 0
    for eng in (port, ref):
        with pytest.raises(RuntimeError, match="window=True"):
            eng.recompute_distributed()
    kw = dict(window=True, cap_factor=8.0, route_cap_factor=8.0)
    got = port.recompute_distributed(**kw)
    assert (got.count, got.checksum) == (port.window_count, port.window_checksum)
    _same(got, ref.recompute_distributed(**kw))


def test_recompute_after_host_loss_matches_jax():
    """``tests/test_recovery.py:67``'s invariant after a replayed host loss:
    the maintained window == the oracle == the distributed replay, in both
    packages alike."""
    rng = np.random.default_rng(0)
    cfg = dict(q=60, decay=0.5, load_factor=2.0)
    port = tstream.StreamingJoinEngine(tcore.two_way(), tstream.StreamConfig(
        **cfg, retention=tstream.RetentionPolicy(window_batches=4),
        recovery=tstream.RecoveryPolicy(n_hosts=8)), device="cpu")
    ref = jstream.StreamingJoinEngine(jcore.two_way(), jstream.StreamConfig(
        **cfg, retention=jstream.RetentionPolicy(window_batches=4),
        recovery=jstream.RecoveryPolicy(n_hosts=8)))
    for i in range(5):
        batch = _zipf_batch(rng, 0 if i < 3 else 300)
        port.ingest(batch)
        ref.ingest(batch)
    assert port.fail_hosts([2]).mode == ref.fail_hosts([2]).mode == "replay"
    count, checksum, _, _ = tmr.oracle_join(port.query, port.history_data())
    assert (port.window_count, port.window_checksum) == (count, checksum)
    kw = dict(window=True, cap_factor=24.0, route_cap_factor=24.0)
    got = port.recompute_distributed(**kw)
    assert got.overflow == 0 and (got.count, got.checksum) == (count, checksum)
    _same(got, ref.recompute_distributed(**kw))
