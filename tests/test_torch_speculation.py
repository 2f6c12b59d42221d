"""The port's speculative reduce shards against the JAX package's: the cases
of ``tests/test_faults.py`` (shard faults, the runner's outcome contract,
corrupt results) and ``tests/test_mapreduce.py``'s speculative join, each
run through both packages on one seeded input.  Every ``JoinResult`` field
and the fault injector's ``FaultReport`` must be equal, and so must every
error a case raises.

The JAX side of each join case runs once per module in a fixture; the port
runs on the CPU through the block join's plain version, from worker
threads as on a card.
"""
import dataclasses
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import data as jdata
from repro import mapreduce as jmr
from repro import testing as jtesting
from repro.mapreduce import straggler as jstraggler
from repro_torch import core as tcore
from repro_torch import mapreduce as tmr
from repro_torch import testing as ttesting
from repro_torch.kernels import _build
from repro_torch.mapreduce import straggler as tstraggler

pytestmark = pytest.mark.faults

_HEX = re.compile(r"0x[0-9a-f]{8}")


def _sharded_data():
    """``tests/test_faults.py``'s 2-way join with three pinned heavy hitters:
    a plan of at least four residual joins, so three shards are real."""
    rng = np.random.default_rng(0)
    n, domain = 3000, 2000
    heavy = np.concatenate([np.full(600, 5), np.full(500, 17), np.full(400, 42)])
    b_r = np.concatenate([heavy, rng.integers(0, domain, n - heavy.size)])
    r = np.stack([rng.integers(0, domain, n), b_r], 1).astype(np.int64)
    b_s = np.concatenate(
        [np.full(120, 5), np.full(100, 17), np.full(80, 42), rng.integers(0, domain, 300)]
    )
    s = np.stack([b_s, rng.integers(0, domain, 600)], 1).astype(np.int64)
    return {"R": r, "S": s}


# Each case: (fault specs, run_join_speculative keyword arguments); the same
# schedules as ``tests/test_faults.py``.
_CASES = {
    "drop": ([dict(kind="drop", shard_id=0, attempt=1)], {}),
    "preempt": ([dict(kind="preempt", shard_id=1, attempt=1)], {}),
    "duplicate": ([dict(kind="duplicate", shard_id=2)], {}),
    "delay": ([dict(kind="delay", shard_id=0, attempt=1, delay_s=0.4)],
              dict(speculate_after=2.0)),
    "every_class": ([dict(kind="drop", shard_id=0, attempt=1),
                     dict(kind="preempt", shard_id=1, attempt=1),
                     dict(kind="duplicate", shard_id=2),
                     dict(kind="delay", shard_id=2, attempt=1, delay_s=0.2)], {}),
    "exhausted": ([dict(kind="drop", shard_id=1, attempt=a) for a in (1, 2, 3)],
                  dict(max_attempts=3)),
    "corrupt": ([dict(kind="corrupt_result", shard_id=0, attempt=1)], {}),
    "corrupt_every": ([dict(kind="corrupt_result", shard_id=1, attempt=a) for a in (1, 2, 3)],
                      dict(max_attempts=3)),
}


def _fields(res):
    return (res.count, res.checksum, res.comm_tuples, res.reducer_loads.tolist(),
            res.overflow)


def _speculative(pkg_mr, testing, query, data, plan, name, **extra):
    """One case through one package: (the result's fields or the error's
    text, the fault report)."""
    specs, kw = _CASES[name]
    inj = testing.FaultInjector([testing.FaultSpec(**s) for s in specs])
    kw = dict(dict(cap_factor=4.0, n_shards=3), **kw, **extra)
    try:
        out = _fields(pkg_mr.run_join_speculative(query, data, plan, injector=inj, **kw))
    except RuntimeError as e:
        out = ("error", str(e))
    inj.assert_all_resolved()
    return out, dataclasses.asdict(inj.report())


@pytest.fixture(scope="module")
def case():
    data = _sharded_data()
    jplan = jcore.plan_shares_skew(jcore.two_way(), data, q=150)
    tplan = tcore.plan_from_arrays(**tcore.plan_to_arrays(jplan))
    assert len(jplan.residuals) >= 3, "fault targets must map to real shards"
    base = jmr.run_join(jcore.two_way(), data, jplan, cap_factor=4.0)
    runs = {name: _speculative(jmr, jtesting, jcore.two_way(), data, jplan, name)
            for name in _CASES}
    return data, tplan, _fields(base), runs


@pytest.mark.parametrize("name", list(_CASES))
def test_speculative_join_under_faults_matches_reference(case, name):
    """Every shard fault class, alone and together: the port's result (or
    its loud error after ``max_attempts``) and its fault report equal the
    JAX package's; a result equals the unfaulted ``run_join``."""
    data, tplan, base, runs = case
    got = _speculative(tmr, ttesting, tcore.two_way(), data, tplan, name, device="cpu")
    out, report = got
    want, want_report = runs[name]
    assert report == want_report
    if name in ("exhausted", "corrupt_every"):
        # the CRCs in the message hash each package's own pickled result
        assert out[0] == want[0] == "error"
        assert _HEX.sub("0x?", out[1]) == _HEX.sub("0x?", want[1])
        assert ("shard 1" if name == "exhausted" else "ChecksumMismatch") in out[1]
        assert report["reported"] >= 1
    else:
        assert out == want
        # a sub-plan hashes its residuals under their own indices, so only
        # the reducer loads differ from the monolithic run's
        assert out[:3] + out[4:] == base[:3] + base[4:]
    assert report["unresolved"] == 0
    if name == "corrupt":
        assert (report["injected"], report["retried_ok"]) == (1, 1)


def test_speculative_join_matches_plain():
    """``tests/test_mapreduce.py``: the 3-way query over three shards with no
    fault equals the monolithic run, in both packages."""
    data = jdata.paper_3way(np.random.default_rng(9), n=400, domain=300)
    jplan = jcore.plan_shares_skew(jcore.three_way_paper(), data, q=120)
    tplan = tcore.plan_from_arrays(**tcore.plan_to_arrays(jplan))
    tq = tcore.three_way_paper()
    want = jmr.run_join_speculative(jcore.three_way_paper(), data, jplan, cap_factor=4.0,
                                    n_shards=3)
    got = tmr.run_join_speculative(tq, data, tplan, cap_factor=4.0, n_shards=3, device="cpu")
    base = tmr.run_join(tq, data, tplan, cap_factor=4.0, device="cpu")
    assert _fields(got) == _fields(want)
    assert (got.count, got.checksum, got.comm_tuples, got.overflow) == (
        base.count, base.checksum, base.comm_tuples, 0)


def test_speculative_join_takes_no_cuda_without_a_card(case):
    data, tplan, _, _ = case
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmr.run_join_speculative(tcore.two_way(), data, tplan)


def _outcomes(outcomes):
    """The outcome fields that do not depend on timing."""
    return [(o.shard_id, o.result, o.attempts, o.error is None) for o in outcomes]


def _both(make, **kw):
    """``run_with_speculation`` of each package over the shard functions
    ``make(pkg)`` gives: both outcome lists."""
    return [pkg.run_with_speculation(make(pkg), **kw) for pkg in (jstraggler, tstraggler)]


def test_runner_outcome_fields():
    """A flaky shard is retried, a doomed one ends with its error on the
    outcome, in both packages alike."""
    def make(pkg):
        calls = {"n": 0}
        fault = jtesting.InjectedFault if pkg is jstraggler else ttesting.InjectedFault

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise fault("first attempt dies")
            return 42

        def doomed():
            raise fault("always dies")

        return [flaky, doomed]

    want, got = _both(make, max_attempts=2)
    assert _outcomes(got) == _outcomes(want)
    assert got[0].result == 42 and got[0].attempts == 2 and got[0].error is None
    assert got[1].result is None and got[1].attempts == 2
    assert got[1].error == want[1].error and "always dies" in got[1].error


def test_backup_latency_is_the_winning_attempts_own():
    """A zombie fenced by the deadline does not set the winner's latency."""
    def make(_pkg):
        calls = []

        def hang_then_fast():
            first = not calls
            calls.append(1)
            if first:
                time.sleep(1.0)
                return "zombie"
            return "fresh"

        return [hang_then_fast]

    kw = dict(max_attempts=2, deadline_s=0.25, poll_interval_s=0.01, speculate_after=100.0)
    want, got = _both(make, **kw)
    assert _outcomes(got) == _outcomes(want) == [(0, "fresh", 2, True)]
    assert got[0].elapsed_s < 0.2


def test_terminal_error_race_one_outcome_per_shard():
    """A terminal error held while a backup is in flight still yields one
    outcome per shard, carrying the error."""
    def make(pkg):
        fault = jtesting.InjectedFault if pkg is jstraggler else ttesting.InjectedFault

        def doomed():
            time.sleep(0.2)
            raise fault("dies slowly")

        return [doomed, lambda: 1, lambda: 2]

    kw = dict(max_attempts=2, speculate_after=0.5, min_completed_before_speculation=2,
              poll_interval_s=0.01)
    want, got = _both(make, **kw)
    assert _outcomes(got) == _outcomes(want)
    assert [o.shard_id for o in got] == [0, 1, 2]
    assert got[0].result is None and "dies slowly" in got[0].error and got[0].attempts == 2
    assert (got[1].result, got[2].result) == (1, 2)


def test_corrupt_result_without_envelope_refused():
    """Corrupting a result that is not sealed fails the attempt; the
    unfaulted retry succeeds."""
    outs = []
    for pkg, testing in ((jstraggler, jtesting), (tstraggler, ttesting)):
        inj = testing.FaultInjector([testing.FaultSpec(kind="corrupt_result", shard_id=0,
                                                       attempt=1)])
        outs.append(pkg.run_with_speculation([lambda: 7], injector=inj,
                                             checksum_results=False, max_attempts=2))
    assert _outcomes(outs[1]) == _outcomes(outs[0]) == [(0, 7, 2, True)]


def test_sealed_result_detects_a_flipped_byte():
    """The CRC envelope round-trips a result and refuses a tampered one
    with the same message as the JAX package's."""
    sealed = tstraggler.SealedResult.seal({"count": 3})
    assert sealed.unseal() == {"count": 3}
    assert sealed.crc == jstraggler.SealedResult.seal({"count": 3}).crc
    bad = dataclasses.replace(sealed, payload=bytes([sealed.payload[0] ^ 0xFF])
                              + sealed.payload[1:])
    jbad = jstraggler.SealedResult(bad.payload, bad.crc)
    with pytest.raises(tstraggler.ChecksumMismatch) as got:
        bad.unseal()
    with pytest.raises(jstraggler.ChecksumMismatch) as want:
        jbad.unseal()
    assert str(got.value) == str(want.value)


def test_runner_metrics_match_reference():
    """The runner's ``straggler_*`` series under the same faults."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry as TRegistry

    snaps = []
    for pkg, testing, reg in ((jstraggler, jtesting, JRegistry(enabled=True)),
                              (tstraggler, ttesting, TRegistry(enabled=True))):
        inj = testing.FaultInjector([
            testing.FaultSpec(kind="drop", shard_id=0, attempt=1),
            testing.FaultSpec(kind="corrupt_result", shard_id=1, attempt=1)])
        pkg.run_with_speculation([lambda: 1, lambda: 2], injector=inj,
                                 checksum_results=True, metrics=reg)
        counters = reg.snapshot()["counters"]
        snaps.append({k: v for k, v in counters.items() if k.startswith("straggler_")})
    assert snaps[1] == snaps[0]
    assert snaps[1]["straggler_retries_total"] == 2
    assert snaps[1]["straggler_checksum_mismatches_total"] == 1


def test_build_all_from_threads_builds_each_source_once(tmp_path, monkeypatch):
    """Worker threads that first reach a kernel together build it once,
    into temporary names of their own, and every launch count survives
    the race (nvcc and the loader stubbed)."""
    built, tmps = [], []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_):
            tmp = cmd[cmd.index("-o") + 1]
            tmps.append(tmp)
            built.append(cmd[-1])
            time.sleep(0.05)  # a slow compiler widens the race
            with open(tmp, "wb") as f:
                f.write(b"lib")

        def communicate(self):
            return "ptxas info    : Used 32 registers", None

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_loaded", {})
    counts = {"k": 0}
    start = threading.Barrier(8)
    got, errors = [], []

    def worker():
        try:
            start.wait()
            got.append(_build.build_all(["block_join", "cms_update"]))
            for _ in range(500):
                _build.count_launch(counts, "k")
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert sorted(built) == sorted(str(_build.SOURCES[n]) for n in ("block_join", "cms_update"))
    assert len(set(tmps)) == len(tmps)
    assert all(t.endswith(".tmp") and f".{os.getpid()}." in t for t in tmps)
    assert all(g["block_join"] is got[0]["block_join"] for g in got)
    assert counts["k"] == 8 * 500
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        _build._target(n).name for n in ("block_join", "cms_update"))
