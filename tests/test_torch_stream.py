"""The torch port's streaming engine against the JAX package's, bit for bit:
every ``BatchReport`` (without its ``obs`` payload) and the heavy-hitter
tracker's final state, on drifting Zipf streams.

The JAX side runs its baseline engine (``fused_ingest=False``), which
needs no Pallas interpret mode; the JAX package's own contract is that its
fused path equals its baseline, and one small fused JAX run here checks
that contract on the port's fused path directly.  The port runs on the
CPU (``device="cpu"``), through the kernels' plain versions."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import stream as jstream
from repro.mapreduce import straggler as jstraggler
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch import stream as tstream
from repro_torch.mapreduce import oracle_join
from repro_torch.mapreduce import straggler as tstraggler


def _zipf_batch(rng, shift, n_r, n_s, domain, a):
    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _drifting_stream(seed=0, n_batches=6, n_r=300, n_s=80, domain=4000):
    """bench_stream's shape, small: 4:1 rows, the heavy values and the Zipf
    exponent move mid-run."""
    rng = np.random.default_rng(seed)
    return [
        _zipf_batch(rng, 0 if i < n_batches // 2 else 1300, n_r, n_s, domain,
                    2.0 if i < n_batches // 2 else 1.4)
        for i in range(n_batches)
    ]


def _lopsided_stream(seed=15):
    rng = np.random.default_rng(seed)
    z = np.zeros((0, 2), dtype=np.int64)
    return [
        {"R": z, "S": rng.integers(0, 100, (50, 2)).astype(np.int64)},
        {"R": rng.integers(0, 100, (80, 2)).astype(np.int64), "S": z},
        {"R": z, "S": z},
        _zipf_batch(rng, 0, 200, 60, 500, 1.8),
        {"R": rng.integers(0, 500, (1, 2)).astype(np.int64), "S": z},
    ]


def _three_way_stream(seed=12, n_batches=3):
    rng = np.random.default_rng(seed)
    return [tdata.paper_3way(rng, n=120, domain=150) for _ in range(n_batches)]


def _report(r):
    d = dataclasses.asdict(r)
    d.pop("obs")
    return d


def _run(engine, batches):
    reports = [_report(engine.ingest(b)) for b in batches]
    return reports, engine.tracker.state_dict()


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


_BASE = dict(q=40, decay=0.5, load_factor=2.0)
_BOUNDED = dict(
    _BASE,
    retention=dict(window_batches=3),
    admission=dict(headroom=0.5, max_backlog_rows=200, min_admit=16),
)


def _config(pkg, **kw):
    kw = dict(kw)
    if "retention" in kw:
        kw["retention"] = pkg.RetentionPolicy(**kw["retention"])
    if "admission" in kw:
        kw["admission"] = pkg.AdmissionPolicy(**kw["admission"])
    return pkg.StreamConfig(**kw)


_STREAMS = {
    "drift": (jcore.two_way, tcore.two_way, _drifting_stream, _BASE),
    "bounded": (jcore.two_way, tcore.two_way, _drifting_stream, _BOUNDED),
    "lopsided": (jcore.two_way, tcore.two_way, _lopsided_stream, dict(q=100)),
    "3way": (jcore.three_way_paper, tcore.three_way_paper, _three_way_stream,
             dict(q=60, hh_threshold=20)),
}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX baseline engine's reports and final tracker state, once per
    stream."""
    out = {}
    for name, (jq, _, make, kw) in _STREAMS.items():
        eng = jstream.StreamingJoinEngine(jq(), _config(jstream, **kw))
        out[name] = _run(eng, make())
    return out


_VARIANTS = {
    "baseline": dict(),
    "fused": dict(fused_ingest=True),
    "fused_static": dict(fused_ingest=True, fused_dynamic_routes=False),
    "device_sketch": dict(use_device_sketch=True),
    "fused_device_sketch": dict(fused_ingest=True, use_device_sketch=True),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("stream", sorted(_STREAMS))
def test_port_engine_equals_jax_engine(jax_runs, stream, variant):
    _, tq, make, kw = _STREAMS[stream]
    eng = tstream.StreamingJoinEngine(
        tq(), _config(tstream, **kw, **_VARIANTS[variant]), device="cpu"
    )
    reports, state = _run(eng, make())
    want_reports, want_state = jax_runs[stream]
    assert len(reports) == len(want_reports)
    for i, (got, want) in enumerate(zip(reports, want_reports)):
        assert got == want, f"batch {i}"
    _assert_state_equal(state, want_state)
    if eng.config.fused_ingest:
        assert eng.fused_batches == len(reports)
    # the join over the carried state equals the window fingerprint
    assert eng._state_join_fingerprint() == (eng.window_count, eng.window_checksum)
    if stream == "drift":
        assert eng.replan_count >= 1
        assert (eng.total_count, eng.total_checksum) == oracle_join(tq(), eng.history_data())[:2]
    if stream == "bounded":
        assert eng.expired_batches > 0 and eng.total_deferred + eng.total_shed > 0


def test_port_fused_equals_jax_fused_in_interpret_mode():
    """The one JAX fused run: its Pallas pass in interpret mode against the
    port's fused path, on the small lopsided stream."""
    batches = _lopsided_stream()
    jeng = jstream.StreamingJoinEngine(
        jcore.two_way(), jstream.StreamConfig(q=100, fused_ingest=True)
    )
    teng = tstream.StreamingJoinEngine(
        tcore.two_way(), tstream.StreamConfig(q=100, fused_ingest=True), device="cpu"
    )
    want, want_state = _run(jeng, batches)
    got, got_state = _run(teng, batches)
    assert got == want
    _assert_state_equal(got_state, want_state)
    assert teng.fused_batches == jeng.fused_batches == len(batches)


def test_observability_spans_on_the_port():
    eng = tstream.StreamingJoinEngine(
        tcore.two_way(),
        tstream.StreamConfig(q=40, fused_ingest=True, obs=tstream.ObsPolicy(trace=True, metrics=True)),
        device="cpu",
    )
    for b in _drifting_stream(n_batches=3):
        report = eng.ingest(b)
    names = set(eng.obs.tracer.span_names())
    assert {"ingest", "route.fused", "sketch.update", "replan.solve", "join.delta"} <= names
    assert report.obs and "metrics" in report.obs


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamingJoinEngine(tcore.two_way(), tstream.StreamConfig(q=10))


def test_failure_detector_matches_reference():
    beats = [("a", 0.0), ("b", 1.0), ("c", 2.5), ("a", 3.0), ("d", 3.0)]
    for deadline in (0.5, 1.0, 2.0):
        det = [tstraggler.FailureDetector(deadline), jstraggler.FailureDetector(deadline)]
        for member, now in beats:
            for d in det:
                d.heartbeat(member, now)
        for d in det:
            d.deregister("d")
            d.deregister("never")
        for now in (3.0, 3.5, 4.0, 6.0):
            assert det[0].overdue(now) == det[1].overdue(now)
        assert det[0].members == det[1].members
    with pytest.raises(ValueError):
        tstraggler.FailureDetector(0)
