"""The port's multi-tenant engine against the JAX package's, case for case
with ``tests/test_tenancy.py`` (shared sketch ingest, tampered fallback,
the isolation proof, overload shedding, breaker backoff, poison modes,
tenant-scoped host loss, namespaced checkpoints, tenant-set mismatch, spec
validation), a malformed shared batch, and ``tests/test_obs.py``'s
per-tenant metric series.

Each scenario runs through both packages on one seeded stream; every
tenant's ``BatchReport`` (without ``obs``) batch by batch, its
``(total_count, total_checksum)`` and private sketch passes, every
``TenantStatus``, ``shared_sketch_passes``, the fair-share counters and the
fault injector's ``FaultReport`` must be equal.  The JAX side runs its
baseline engine once per scenario, memoised for the module; the port runs
on the CPU through the kernels' plain versions.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

from repro import core as jcore
from repro import stream as jstream
from repro import testing as jtesting
from repro_torch import core as tcore
from repro_torch import stream as tstream
from repro_torch import testing as ttesting
from repro_torch.mapreduce import oracle_join
from repro_torch.stream import tenancy as ttenancy

pytestmark = pytest.mark.tenancy

JAX = SimpleNamespace(stream=jstream, core=jcore, testing=jtesting, kw={})
PORT = SimpleNamespace(stream=tstream, core=tcore, testing=ttesting, kw={"device": "cpu"})

N_BATCHES = 8


def _zipf_batch(rng, shift, n_r=240, n_s=80, domain=600, a=1.6):
    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _batches(n=N_BATCHES, seed=0):
    rng = np.random.default_rng(seed)
    return [_zipf_batch(rng, 0 if i < n // 2 else 300) for i in range(n)]


def _cfg(P, **kw):
    return P.stream.StreamConfig(q=60, decay=0.5, load_factor=2.0, **kw)


def _specs(P, names, **cfgs):
    return [P.stream.TenantSpec(nm, P.core.two_way(), cfgs.get(nm) or _cfg(P)) for nm in names]


def _injector(P, *specs):
    return P.testing.FaultInjector([P.testing.FaultSpec(**s) for s in specs])


def _report(r):
    if r is None:
        return None
    d = dataclasses.asdict(r)
    d.pop("obs")
    return d


def _trace(mq, outs, inj=None, extra=None):
    """Everything of a run that both packages must agree on."""
    return {
        "outs": [{nm: _report(r) for nm, r in out.items()} for out in outs],
        "status": {nm: dataclasses.asdict(st) for nm, st in mq.status().items()},
        "serving": mq.serving(),
        "batches": mq.batches,
        "passes": mq.shared_sketch_passes,
        "fair": (dict(mq.fair.overload_shed), dict(mq.fair.backpressure)),
        "engines": {
            nm: (e.total_count, e.total_checksum, e.sketch_ingest_calls,
                 [_report(r) for r in e.reports])
            for nm in mq.status() for e in [mq.engine(nm)]
        },
        "faults": None if inj is None else dataclasses.asdict(inj.report()),
        "extra": extra,
    }


def _capacity(P, mq, b):
    """1.5x the observed steady demand: normal load fits, a 4000-row burst
    does not (``tests/test_tenancy.py``)."""
    return 1.5 * sum(
        len(b[rel.name]) * P.stream.replication_width(mq.engine(nm).plan, rel.name)
        for nm in mq.serving() for rel in P.core.two_way().relations
    )


# ---- the scenarios: each drives one package and returns (engine, trace) ----
def _shared(P):
    mq = P.stream.MultiQueryEngine(_specs(P, ["t0", "t1", "t2"]), **P.kw)
    outs = [mq.ingest(b) for b in _batches()]
    return mq, _trace(mq, outs)


def _tampered(P):
    mq = P.stream.MultiQueryEngine(_specs(P, ["a", "b"]), **P.kw)
    inj = _injector(P, dict(kind="tenant_overload", target="tenant", tenant="b", batch=3,
                            rel="R", rows=500))
    mq.arm_faults(inj)
    outs = [mq.ingest(b) for b in _batches()]
    inj.assert_all_resolved()
    return mq, _trace(mq, outs, inj)


def _isolation(P):
    mq = P.stream.MultiQueryEngine(
        _specs(P, ["A", "B", "C", "D"], B=_cfg(P, recovery=P.stream.RecoveryPolicy(
            n_hosts=4, min_hosts=4))),
        P.stream.TenancyPolicy(breaker_backoff=1), **P.kw)
    inj = _injector(
        P, dict(kind="poison_rows", target="tenant", tenant="A", batch=2, poison="domain"),
        dict(kind="tenant_overload", target="tenant", tenant="C", batch=5, rel="R", rows=4000))
    mq.arm_faults(inj)
    outs, killed = [], None
    for i, b in enumerate(_batches()):
        if i == 4:
            killed = mq.fail_hosts("B", [0])
        if i == 5:
            mq.fair.capacity = _capacity(P, mq, b)
        outs.append(mq.ingest(b))
        if i == 5:
            mq.fair.capacity = None
    inj.assert_all_resolved()
    return mq, _trace(mq, outs, inj, extra=killed)


def _overload(P):
    mq = P.stream.MultiQueryEngine(_specs(P, ["hog", "calm"]), **P.kw)
    inj = _injector(P, dict(kind="tenant_overload", target="tenant", tenant="hog", batch=4,
                            rel="R", rows=4000))
    mq.arm_faults(inj)
    outs = []
    for i, b in enumerate(_batches()):
        if i == 4:
            mq.fair.capacity = _capacity(P, mq, b)
        outs.append(mq.ingest(b))
        if i == 4:
            mq.fair.capacity = None
    inj.assert_all_resolved()
    return mq, _trace(mq, outs, inj)


def _breaker(P):
    mq = P.stream.MultiQueryEngine(
        _specs(P, ["sick", "ok"]),
        P.stream.TenancyPolicy(breaker_backoff=1, breaker_max_reopens=2), **P.kw)
    inj = _injector(P, *[dict(kind="poison_rows", target="tenant", tenant="sick", batch=b,
                              poison="nan") for b in range(12)])
    mq.arm_faults(inj)
    outs, states = [], []
    for b in _batches(12, seed=7):
        outs.append(mq.ingest(b))
        states.append(mq.status()["sick"].state)
    inj.assert_all_resolved()
    return mq, _trace(mq, outs, inj, extra=states)


def _host_loss(P):
    rec = _cfg(P, retention=P.stream.RetentionPolicy(window_batches=4),
               recovery=P.stream.RecoveryPolicy(n_hosts=8))
    mq = P.stream.MultiQueryEngine(_specs(P, ["vic", "oth"], vic=rec), **P.kw)
    outs, rep = [], None
    for i, b in enumerate(_batches()):
        if i == 5:
            rep = dataclasses.asdict(mq.fail_hosts("vic", [2]))
        outs.append(mq.ingest(b))
    vic = mq.engine("vic")
    return mq, _trace(mq, outs, extra=(rep, vic.window_count, vic.window_checksum,
                                       [dataclasses.asdict(r) for r in vic.recoveries]))


def _malformed(P):
    """A malformed SHARED batch (NaN in R's join column at batch 2, a value
    outside int32 in S's at batch 5): every tenant trips its own breaker,
    and nothing raises out of the shared pass."""
    batches = _batches()
    nan = dict(batches[2], R=batches[2]["R"].astype(np.float64))
    nan["R"][0, 1] = np.nan
    wide = dict(batches[5], S=batches[5]["S"].copy())
    wide["S"][0, 0] = 2**40
    batches[2], batches[5] = nan, wide
    mq = P.stream.MultiQueryEngine(_specs(P, ["m0", "m1"]), **P.kw)
    outs = [mq.ingest(b) for b in batches]
    return mq, _trace(mq, outs)


def _obs(P):
    """``tests/test_obs.py``'s per-tenant series: a poison pill in q1."""
    cfg = P.stream.StreamConfig(q=100, decay=0.5, load_factor=2.0)
    mq = P.stream.MultiQueryEngine(
        [P.stream.TenantSpec(f"q{i}", P.core.two_way(), cfg) for i in range(2)],
        P.stream.TenancyPolicy(obs=P.stream.ObsPolicy(metrics=True)), **P.kw)
    inj = _injector(P, dict(kind="poison_rows", target="tenant", tenant="q1", batch=2,
                            poison="nan"))
    mq.arm_faults(inj)
    rng = np.random.default_rng(11)
    outs = []
    for _ in range(5):
        b_r = (rng.zipf(1.7, 900) - 1) % 2500
        b_s = (rng.zipf(1.7, 250) - 1) % 2500
        outs.append(mq.ingest({
            "R": np.stack([rng.integers(0, 2500, 900), b_r], 1).astype(np.int64),
            "S": np.stack([b_s, rng.integers(0, 2500, 250)], 1).astype(np.int64)}))
    inj.assert_all_resolved()
    snap = mq.obs.metrics.snapshot()
    return mq, _trace(mq, outs, inj, extra=(snap["counters"], snap["gauges"],
                                            sorted(snap["histograms"])))


def _checkpoint_specs(P):
    return [P.stream.TenantSpec("t0", P.core.two_way(), _cfg(P), weight=2.0),
            P.stream.TenantSpec("t1", P.core.two_way(), _cfg(P))]


_CKPT_POLICY = dict(breaker_backoff=2)
_CKPT_FAULT = dict(kind="poison_rows", target="tenant", tenant="t1", batch=3, poison="domain")


def _checkpoint_half(P, directory):
    """Four batches with t1 poisoned at batch 3, then a checkpoint."""
    mq = P.stream.MultiQueryEngine(_checkpoint_specs(P), P.stream.TenancyPolicy(**_CKPT_POLICY),
                                   **P.kw)
    mq.arm_faults(_injector(P, _CKPT_FAULT))
    outs = [mq.ingest(b) for b in _batches()[:4]]
    mq.save_checkpoint(str(directory))
    return mq, _trace(mq, outs)


def _checkpoint_resume(P, directory):
    """Restore a checkpoint (either package's) and ingest batches 4..7."""
    mq = P.stream.MultiQueryEngine.restore(
        str(directory), _checkpoint_specs(P), P.stream.TenancyPolicy(**_CKPT_POLICY), **P.kw)
    restored = {nm: dataclasses.asdict(st) for nm, st in mq.status().items()}
    outs = [mq.ingest(b) for b in _batches()[4:]]
    return mq, _trace(mq, outs, extra=restored)


_SCENARIOS = {
    "shared": _shared, "tampered": _tampered, "isolation": _isolation,
    "overload": _overload, "breaker": _breaker, "host_loss": _host_loss,
    "malformed": _malformed, "obs": _obs,
}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side of a scenario, run at most once in the module."""
    return functools.lru_cache(maxsize=None)(lambda name: _SCENARIOS[name](JAX)[1])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package's half run and its checkpoint, and its resumed run."""
    d = tmp_path_factory.mktemp("jax_tenancy")
    _, half = _checkpoint_half(JAX, d)
    _, resumed = _checkpoint_resume(JAX, d)
    return d, half, resumed


def _solo(batches=None, config=None):
    eng = tstream.StreamingJoinEngine(tcore.two_way(), config or _cfg(PORT), device="cpu")
    for b in batches or _batches():
        eng.ingest({k: v.copy() for k, v in b.items()})
    return eng


# ---- shared sketch ingest --------------------------------------------------
def test_shared_sketch_runs_once_and_absorbs_bit_identically(jax_run):
    mq, got = _shared(PORT)
    assert got == jax_run("shared")
    solo = _solo()
    for i in range(3):
        eng = mq.engine(f"t{i}")
        assert eng.sketch_ingest_calls == 0
        assert eng.reports == solo.reports
    assert mq.shared_sketch_passes == 2 * N_BATCHES
    assert solo.sketch_ingest_calls == N_BATCHES


def test_shared_pass_equals_cms_delta():
    """The shared pass (the Count-Min kernel's plain version on the CPU,
    widened to float64) equals the JAX package's ``cms_delta`` for every
    column, a float column truncated as ``cms_delta`` casts it; and the
    port's ``cms_delta`` equals a private ``DecayingCountMin`` update."""
    from repro.stream.sketch import cms_delta as jcms_delta

    rng = np.random.default_rng(3)
    col = rng.integers(0, 10_000, 5_000)
    shared = tstream.DecayingCountMin(width=256, depth=3, seed=9)
    private = tstream.DecayingCountMin(width=256, depth=3, seed=9)
    private.update(col)
    shared.absorb(tstream.cms_delta(col, private.seeds, private.width), len(col))
    assert np.array_equal(shared.table, private.table)

    mq = tstream.MultiQueryEngine(_specs(PORT, ["a", "b"]), device="cpu")
    batch = _batches()[0]
    batch = dict(batch, S=batch["S"].astype(np.float64) + 0.75)
    deltas = mq._shared_deltas(batch)
    assert deltas["a"] is deltas["b"]
    tr = mq.engine("a").tracker
    assert sorted(deltas["a"]) == [("B", "R"), ("B", "S")]
    for (a, rel), got in deltas["a"].items():
        idx = tcore.two_way().relation(rel).index_of(a)
        want = jcms_delta(batch[rel][:, idx], tr.seeds, tr.width)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    assert mq.shared_sketch_passes == 2


def test_tampered_tenant_falls_back_to_private_pass(jax_run):
    mq, got = _tampered(PORT)
    assert got == jax_run("tampered")
    assert mq.engine("a").sketch_ingest_calls == 0
    assert mq.engine("b").sketch_ingest_calls == 1


# ---- the acceptance proof --------------------------------------------------
def test_isolation_proof(jax_run):
    mq, got = _isolation(PORT)
    assert got == jax_run("isolation")
    solo = _solo()
    assert got["extra"] is None
    assert got["faults"]["contained"] == 2 and got["faults"]["unresolved"] == 0
    status = mq.status()
    assert (status["A"].state, status["A"].reopens) == (tstream.RUNNING, 1)
    assert status["B"].state == tstream.FAILED
    assert "RecoveryExhaustedError" in status["B"].last_error
    assert mq.serving() == ["A", "C", "D"]
    d = mq.engine("D")
    assert (d.total_count, d.total_checksum) == (solo.total_count, solo.total_checksum)
    assert d.sketch_ingest_calls == 0 and d.reports == solo.reports
    a = mq.engine("A")
    assert [r.batch for r in a.reports] == [0, 1, 2, 3, 4, 5]
    assert a.reports[:2] == solo.reports[:2] and a.total_count < solo.total_count
    assert len(mq.engine("B").reports) == 4
    assert mq.fair.overload_shed["C"] > 0
    assert mq.fair.overload_shed["D"] == mq.fair.overload_shed["A"] == 0
    assert mq.engine("C").sketch_ingest_calls == 1
    assert mq.shared_sketch_passes == 2 * N_BATCHES


def test_overload_sheds_only_the_offender(jax_run):
    mq, got = _overload(PORT)
    assert got == jax_run("overload")
    assert got["faults"]["contained"] == 1
    assert mq.fair.overload_shed["hog"] > 0 and mq.fair.overload_shed["calm"] == 0
    assert mq.fair.backpressure["hog"] == 1
    calm, solo = mq.engine("calm"), _solo()
    assert (calm.total_count, calm.total_checksum) == (solo.total_count, solo.total_checksum)


# ---- circuit breaker -------------------------------------------------------
def test_breaker_backoff_reopens_then_fails(jax_run):
    mq, got = _breaker(PORT)
    assert got == jax_run("breaker")
    states = got["extra"]
    assert states[0] == states[2] == tstream.QUARANTINED
    assert states[-1] == tstream.FAILED
    assert mq.status()["sick"].reopens == 2
    assert mq.engine("sick").total_count == 0
    ok, solo = mq.engine("ok"), _solo(_batches(12, seed=7))
    assert (ok.total_count, ok.total_checksum) == (solo.total_count, solo.total_checksum)


def test_poison_rejected_before_any_state_mutation():
    """A poisoned batch leaves the victim as it was, in both packages."""
    batches = _batches()
    bad = {"R": batches[4]["R"].astype(np.float64), "S": batches[4]["S"]}
    bad["R"][0, 0] = np.nan
    out = []
    for P in (JAX, PORT):
        ref = P.stream.StreamingJoinEngine(P.core.two_way(), _cfg(P), **P.kw)
        vic = P.stream.StreamingJoinEngine(P.core.two_way(), _cfg(P), **P.kw)
        for b in batches[:4]:
            ref.ingest(b)
            vic.ingest(b)
        with pytest.raises(ValueError, match="poisoned batch") as err:
            vic.ingest(bad)
        assert (vic.total_count, vic.total_checksum) == (ref.total_count, ref.total_checksum)
        ref.ingest(batches[5])
        vic.ingest(batches[5])
        assert (vic.total_count, vic.total_checksum) == (ref.total_count, ref.total_checksum)
        out.append((str(err.value), _report(vic.reports[-1])))
    assert out[0] == out[1]


def test_poison_modes_all_rejected():
    """Each poison mode raises the same error in both packages and leaves
    the total unchanged."""
    good = _batches()[0]
    cases = [
        {"R": good["R"], "S": good["S"][:, :1]},
        {"R": good["R"]},
        {"R": np.where(good["R"] == good["R"][0, 0], 2**40, good["R"]), "S": good["S"]},
        {"R": good["R"].astype(object), "S": good["S"]},
    ]
    msgs = []
    for P in (JAX, PORT):
        eng = P.stream.StreamingJoinEngine(P.core.two_way(), _cfg(P), **P.kw)
        eng.ingest(good)
        n, got = eng.total_count, []
        for bad in cases:
            with pytest.raises(ValueError, match="poisoned batch") as err:
                eng.ingest(bad)
            got.append(str(err.value))
        assert eng.total_count == n
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_malformed_shared_batch_trips_each_tenant(jax_run):
    """NaN and out-of-int32 values in the shared batch: the port's shared
    pass skips those columns instead of raising, and every tenant trips its
    own breaker as in the JAX package.  Only ``shared_sketch_passes`` may
    differ, by the two skipped columns (the JAX pass counts a column it
    computed over the cast values; no tenant reads it)."""
    mq, got = _malformed(PORT)
    want = jax_run("malformed")
    assert got["passes"] == want["passes"] - 2
    assert {k: v for k, v in got.items() if k != "passes"} == {
        k: v for k, v in want.items() if k != "passes"}
    for nm in ("m0", "m1"):
        assert got["outs"][2][nm] is None and got["outs"][5][nm] is None
        st = mq.status()[nm]  # tripped at 2 and 5, reopened at 4 and 7
        assert (st.state, st.failures, st.reopens) == (tstream.RUNNING, 0, 2)
        assert "int32 routing domain" in st.last_error


# ---- tenant-scoped recovery ------------------------------------------------
def test_host_loss_repairs_one_tenant_only(jax_run):
    mq, got = _host_loss(PORT)
    assert got == jax_run("host_loss")
    rep = got["extra"][0]
    assert rep["verified"] and rep["tenant"] == "vic"
    assert mq.status()["vic"].state in (tstream.RUNNING, tstream.DEGRADED)
    oth, solo = mq.engine("oth"), _solo()
    assert (oth.total_count, oth.total_checksum) == (solo.total_count, solo.total_checksum)
    vic = mq.engine("vic")
    w_count, w_checksum, _, _ = oracle_join(tcore.two_way(), vic.history_data())
    assert (vic.window_count, vic.window_checksum) == (w_count, w_checksum)


# ---- checkpoints -----------------------------------------------------------
def test_checkpoint_restore_bit_identical_for_all_tenants(tmp_path, jax_checkpoint):
    """Kill -> restore mid-stream: every tenant (the quarantined one too)
    resumes to the uninterrupted run, and both the half run and the resumed
    run equal the JAX package's."""
    _, jhalf, jresumed = jax_checkpoint
    full = tstream.MultiQueryEngine(_checkpoint_specs(PORT),
                                    tstream.TenancyPolicy(**_CKPT_POLICY), device="cpu")
    full.arm_faults(_injector(PORT, _CKPT_FAULT))
    for b in _batches():
        full.ingest(b)
    _, half = _checkpoint_half(PORT, tmp_path)
    assert half == jhalf
    resumed, got = _checkpoint_resume(PORT, tmp_path)
    assert got == jresumed
    assert resumed.batches == 8 and got["extra"]["t1"]["state"] == tstream.QUARANTINED
    for nm in ("t0", "t1"):
        a, b = full.engine(nm), resumed.engine(nm)
        assert (a.total_count, a.total_checksum) == (b.total_count, b.total_checksum)
        assert [r.batch for r in a.reports] == [r.batch for r in b.reports]
    sa, sb = full.status(), resumed.status()
    for nm in ("t0", "t1"):
        assert (sa[nm].state, sa[nm].failures, sa[nm].reopens) == (
            sb[nm].state, sb[nm].failures, sb[nm].reopens)
    assert full.fair.overload_shed == resumed.fair.overload_shed


def test_checkpoints_restore_across_packages(tmp_path, jax_checkpoint):
    """The JAX package's tenancy checkpoint restores in the port, and the
    port's restores in the JAX package; each resumes to the same run."""
    jdir, _, jresumed = jax_checkpoint
    _, got = _checkpoint_resume(PORT, jdir)
    assert got == jresumed
    _checkpoint_half(PORT, tmp_path)
    back, want = _checkpoint_resume(JAX, tmp_path)
    assert want == jresumed
    assert type(back.engine("t0").plan) is jcore.SharesSkewPlan


def test_checkpoint_rejects_tenant_set_mismatch(tmp_path):
    msgs = []
    for P in (JAX, PORT):
        d = tmp_path / P.stream.__name__
        mq = P.stream.MultiQueryEngine(_specs(P, ["a"]), **P.kw)
        mq.ingest(_batches()[0])
        mq.save_checkpoint(str(d))
        with pytest.raises(ValueError, match="tenant") as err:
            P.stream.MultiQueryEngine.restore(str(d), _specs(P, ["zz"]), **P.kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---- validation ------------------------------------------------------------
def test_tenant_spec_validation():
    msgs = []
    for P in (JAX, PORT):
        got = []
        for make in (
            lambda: P.stream.TenantSpec("a/b", P.core.two_way(), _cfg(P)),
            lambda: P.stream.TenantSpec("__control__", P.core.two_way(), _cfg(P)),
            lambda: P.stream.TenantSpec("a", P.core.two_way(), _cfg(P), weight=0.0),
            lambda: P.stream.MultiQueryEngine(_specs(P, ["a", "a"]), **P.kw),
            lambda: P.stream.TenancyPolicy(breaker_backoff=0),
            lambda: P.stream.TenancyPolicy(breaker_max_reopens=-1),
            lambda: P.stream.MultiQueryEngine([], **P.kw),
        ):
            with pytest.raises(ValueError) as err:
                make()
            got.append(str(err.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    for word, msg in zip(("filename-safe", "reserved", "weight", "duplicate",
                          "breaker_backoff"), msgs[1]):
        assert word in msg


def test_multi_query_engine_takes_no_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.MultiQueryEngine(_specs(PORT, ["a"]))


# ---- per-tenant observability ----------------------------------------------
def test_tenant_label_isolation(jax_run):
    """One shared registry, disjoint series: the poison pill in q1 shows in
    q1's series alone; every counter and gauge equals the JAX package's."""
    mq, got = _obs(PORT)
    assert got == jax_run("obs")
    counters = got["extra"][0]
    trips = {k: v for k, v in counters.items()
             if k.startswith("tenancy_breaker_transitions_total")}
    assert trips and all('tenant="q1"' in k for k in trips), trips
    assert counters['stream_batches_total{tenant="q0"}'] == 5
    assert counters['stream_batches_total{tenant="q1"}'] < 5
    assert counters["tenancy_shared_sketch_passes_total"] == mq.shared_sketch_passes == 10
    assert isinstance(mq.engine("q0").obs, type(mq.obs)) and mq.engine("q0").obs.tenant == "q0"


def test_kernel_keys_refuse_what_tenants_reject():
    """The shared pass's key conversion: exact int32 where ``_validate_batch``
    would accept the column, None where it would reject it."""
    assert ttenancy._kernel_keys(np.array([1, -(2**31), 2**31 - 1])).tolist() == [
        1, -(2**31), 2**31 - 1]
    assert ttenancy._kernel_keys(np.array([1.9, -2.5])).tolist() == [1, -2]
    for bad in (np.array([1.0, np.nan]), np.array([np.inf]), np.array([2**31]),
                np.array([-(2**31) - 1]), np.array([1, 2], dtype=object),
                np.array(["a"]), np.array([True])):
        assert ttenancy._kernel_keys(bad) is None
