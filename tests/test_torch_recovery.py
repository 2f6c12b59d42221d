"""The port's reducer-loss recovery against the JAX package's, on the streams
of ``tests/test_recovery.py``: every ``BatchReport`` (without ``obs``) and
every ``RecoveryReport`` of the port equals the JAX engine's, field for
field, for single- and multi-host replay, replay without retention,
detection at the deadline, a partition that heals, elastic degrade and
exhaustion, on both of the port's ingest paths.

The JAX side runs its baseline engine (``fused_ingest=False``; its own
contract is that the fused path equals it), once per stream in a module
fixture.  The port runs on the CPU through the kernels' plain versions.
After every scenario but exhaustion the port's window fingerprint is
checked against the port's ``oracle_join``, against the join over its
carried state, and, as ``tests/test_recovery.py:60-71`` checks the JAX
engine's, against a replay of the retained window through the distributed
shuffle (``recompute_distributed(window=True)`` at the reference's caps of
24, on this process's one-rank gloo group): no overflow, the oracle's
``(count, checksum)``, and the JAX engine's own replay of the same scenario
field for field.
"""
import dataclasses
import re

import numpy as np
import pytest

from repro import core as jcore
from repro import stream as jstream
from repro import testing as jtesting
from repro.train import elastic as jelastic
from repro_torch import core as tcore
from repro_torch import stream as tstream
from repro_torch import testing as ttesting
from repro_torch.mapreduce import oracle_join
from repro_torch.train import elastic as telastic

pytestmark = pytest.mark.recovery


def _zipf_batch(rng, shift, n_r=240, n_s=80, domain=600, a=1.6):
    """Skewed 2-way batch; ``shift`` rotates the hot keys (drift)."""
    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _batches(seed, shifts):
    rng = np.random.default_rng(seed)
    return [_zipf_batch(rng, s) for s in shifts]


def _cfg(pkg, retention=True, recovery=None, admission=None, **kw):
    return pkg.StreamConfig(
        q=60, decay=0.5, load_factor=2.0,
        retention=pkg.RetentionPolicy(window_batches=4) if retention else pkg.RetentionPolicy(),
        recovery=pkg.RecoveryPolicy(**(dict(n_hosts=8) if recovery is None else recovery)),
        admission=pkg.AdmissionPolicy(**admission) if admission else pkg.AdmissionPolicy(),
        **kw,
    )


def _drift(n, at):
    return [0 if i < at else 300 for i in range(n)]


# Each scenario: (seed, shifts, config kwargs, steps).  A step is an int
# (ingest that batch), ("kill", hosts) (``fail_hosts``), or ("arm", specs)
# (``arm_faults`` with a fresh injector); ``tests/test_recovery.py`` runs
# the same streams.
_SCENARIOS = {
    "single_host": (0, _drift(9, 3), {}, [0, 1, 2, 3, 4, ("kill", [2]), 5, 6, 7, 8]),
    "multi_host": (1, _drift(6, 3), {}, [0, 1, 2, 3, 4, 5, ("kill", [0, 5])]),
    "no_retention": (2, _drift(5, 5), dict(retention=False), [0, 1, 2, 3, 4, ("kill", [3])]),
    "fused_stream": (3, _drift(9, 3), {}, [0, 1, 2, 3, 4, ("kill", [2]), 5, 6, 7, 8]),
    "deadline": (4, _drift(8, 4), {},
                 [("arm", [dict(kind="host_loss", target="host", host_id=3, batch=4)])]
                 + list(range(8))),
    "partition": (5, _drift(7, 7), {},
                  [("arm", [dict(kind="partition", target="host", host_id=1, batch=3,
                                 heal_after=2)])] + list(range(7))),
    "degrade": (6, _drift(8, 3), dict(admission=dict(headroom=4.0)),
                [0, 1, 2, 3, 4, ("kill", [0, 1]), ("kill", [2, 3, 4]), 5, 6, 7]),
    "exhaustion": (7, _drift(5, 5), dict(recovery=dict(n_hosts=4, min_hosts=2)),
                   [0, 1, 2, 3, ("kill", [0, 1, 2]), 4]),
}


def _report(r):
    d = dataclasses.asdict(r)
    d.pop("obs")
    return d


def _run(pkg, core, testing, name, extra=None, **engine_kw):
    """Drive one scenario, its config updated by ``extra``; returns (the
    engine, the injector or None, the trace: every report, recovery and
    error in order)."""
    seed, shifts, kw, steps = _SCENARIOS[name]
    batches = _batches(seed, shifts)
    eng = pkg.StreamingJoinEngine(
        core.two_way(), _cfg(pkg, **kw, **(extra or {})), **engine_kw)
    inj, trace = None, []
    for step in steps:
        try:
            if isinstance(step, int):
                trace.append(("batch", _report(eng.ingest(batches[step]))))
            elif step[0] == "kill":
                rep = eng.fail_hosts(step[1])
                trace.append(("recovery", None if rep is None else dataclasses.asdict(rep)))
            else:
                inj = testing.FaultInjector([testing.FaultSpec(**s) for s in step[1]])
                eng.arm_faults(inj)
        except pkg.RecoveryExhaustedError as e:
            trace.append(("error", str(e)))
    trace.append(("recoveries", [dataclasses.asdict(r) for r in eng.recoveries]))
    trace.append(("hosts", eng._hosts.alive, eng._hosts.host_of.tolist()))
    return eng, inj, trace


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run(jstream, jcore, jtesting, name) for name in _SCENARIOS}


_VARIANTS = {"baseline": {}, "fused": dict(fused_ingest=True)}

# degraded plans concentrate the window on few reducers; the reference's
# generous caps keep the replay free of overflow, so it is exact
_RECOMPUTE = dict(window=True, cap_factor=24.0, route_cap_factor=24.0)


@pytest.fixture(scope="module")
def jax_recomputes(jax_runs):
    """The JAX engine's distributed replay of each scenario's window."""
    return {name: jax_runs[name][0].recompute_distributed(**_RECOMPUTE)
            for name in _SCENARIOS if name != "exhaustion"}


def _assert_window_exact(eng, want):
    """The window fingerprint equals the port's oracle on the retained
    input, the join over the carried binned state, and the distributed
    replay of the window, which equals the JAX engine's (``want``)."""
    count, checksum, _, _ = oracle_join(eng.query, eng.history_data())
    assert (eng.window_count, eng.window_checksum) == (count, checksum)
    assert eng._state_join_fingerprint() == (count, checksum)
    res = eng.recompute_distributed(**_RECOMPUTE)
    assert res.overflow == 0
    assert (res.count, res.checksum) == (count, checksum)
    assert (res.count, res.checksum, res.comm_tuples, res.overflow) == (
        want.count, want.checksum, want.comm_tuples, want.overflow)
    np.testing.assert_array_equal(res.reducer_loads, want.reducer_loads)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_port_recovery_equals_jax(jax_runs, jax_recomputes, name, variant):
    eng, inj, trace = _run(tstream, tcore, ttesting, name, _VARIANTS[variant], device="cpu")
    _, jinj, want = jax_runs[name]
    assert len(trace) == len(want)
    for i, (got, exp) in enumerate(zip(trace, want)):
        assert got == exp, f"step {i} of {name}"
    if inj is not None:
        inj.assert_all_resolved()
        assert dataclasses.astuple(inj.report()) == dataclasses.astuple(jinj.report())
    if name != "exhaustion":
        _assert_window_exact(eng, jax_recomputes[name])
    if variant == "fused":
        assert eng.fused_batches == len(eng.reports)


def test_single_host_loss_replays_exactly():
    eng, _, _ = _run(tstream, tcore, ttesting, "single_host", device="cpu")
    rep = eng.recoveries[0]
    assert rep.mode == "replay" and rep.lost_hosts == (2,) and rep.lost_reducers >= 1
    assert rep.verified and rep.replayed_tuples == rep.lost_share_tuples
    assert rep.reducers_before == rep.reducers_after  # plan untouched


def test_injected_host_loss_detected_at_deadline():
    eng, inj, _ = _run(tstream, tcore, ttesting, "deadline", device="cpu")
    assert [(r.batch, r.lost_hosts) for r in eng.recoveries] == [(4, (3,))]
    assert 3 not in eng._hosts.alive
    assert inj.report().recovered == 1


def test_partition_heals_and_host_rejoins_empty():
    eng, inj, _ = _run(tstream, tcore, ttesting, "partition", device="cpu")
    assert len(eng.recoveries) == 1  # partition looks like loss at first
    assert 1 in eng._hosts.alive  # healed and rejoined
    inj.assert_all_resolved()


def test_sustained_loss_degrades_elastically():
    seed, shifts, kw, steps = _SCENARIOS["degrade"]
    batches = _batches(seed, shifts)
    eng = tstream.StreamingJoinEngine(tcore.two_way(), _cfg(tstream, **kw), device="cpu")
    for b in batches[:5]:
        eng.ingest(b)
    combos_before = tuple(r.combo for r in eng.plan.residuals)
    budgets_before = eng._controller.budgets(eng.plan)
    assert eng.fail_hosts([0, 1]).mode == "replay"  # 6/8 alive
    rep = eng.fail_hosts([2, 3, 4])  # 3/8 alive: below 0.5 -> degrade
    assert rep.mode == "degrade" and rep.verified
    assert rep.reducers_after < rep.reducers_before and rep.migrated_tuples > 0
    assert tuple(r.combo for r in eng.plan.residuals) == combos_before
    assert eng._controller.capacity_factor == pytest.approx(3 / 8)
    budgets_after = eng._controller.budgets(eng.plan)
    assert all(budgets_after[nm] <= budgets_before[nm] for nm in budgets_after)


def test_exhaustion_is_loud_and_sticky():
    seed, shifts, kw, _ = _SCENARIOS["exhaustion"]
    batches = _batches(seed, shifts)
    eng = tstream.StreamingJoinEngine(tcore.two_way(), _cfg(tstream, **kw), device="cpu")
    for b in batches[:4]:
        eng.ingest(b)
    with pytest.raises(tstream.RecoveryExhaustedError, match="min_hosts"):
        eng.fail_hosts([0, 1, 2])  # 1 survivor < min_hosts=2
    with pytest.raises(tstream.RecoveryExhaustedError, match="survivable grid"):
        eng.ingest(batches[4])


def test_recovery_disabled_engine_refuses_fail_hosts():
    eng = tstream.StreamingJoinEngine(
        tcore.two_way(), _cfg(tstream, recovery=dict()), device="cpu")
    with pytest.raises(RuntimeError, match="recovery is disabled"):
        eng.fail_hosts([0])


def test_recovery_spans_on_the_port():
    """The recovery boundary, replay and verify spans and the detect
    instant land in the port's tracer, as in the JAX engine."""
    seed, shifts, _, _ = _SCENARIOS["single_host"]
    eng = tstream.StreamingJoinEngine(
        tcore.two_way(), _cfg(tstream, obs=tstream.ObsPolicy(trace=True, metrics=True)),
        device="cpu")
    for b in _batches(seed, shifts)[:5]:
        eng.ingest(b)
    eng.fail_hosts([2])
    names = set(eng.obs.tracer.span_names())
    assert {"recovery.boundary", "recovery.replay", "recovery.verify"} <= names
    instants = {e["name"] for e in eng.obs.tracer.events if e.get("ph") == "i"}
    assert {"recovery.detect", "recovery.report"} <= instants
    snap = eng.obs.metrics.snapshot()
    assert any("stream_recovery_total" in k for k in snap["counters"])


@pytest.mark.parametrize("chips", [1, 2, 3, 7, 8, 255, 256, 257, 600, 1024])
@pytest.mark.parametrize("mp", [1, 2, 4])
@pytest.mark.parametrize("per_pod", [4, 256])
def test_plan_mesh_shape_matches_reference(chips, mp, per_pod):
    call = dict(healthy_chips=chips, model_parallel=mp, chips_per_pod=per_pod)
    try:
        want = dataclasses.astuple(jelastic.plan_mesh_shape(**call))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            telastic.plan_mesh_shape(**call)
        return
    got = telastic.plan_mesh_shape(**call)
    assert dataclasses.astuple(got) == want
    assert got.chips_used + got.chips_idle == chips
