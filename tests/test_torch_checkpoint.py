"""The port's engine checkpoints against the JAX package's: save → kill →
restore → continue equals the uninterrupted run, an armed injector stays
armed across the restore, recovery state survives a checkpoint, both
packages write the same manifest for the same engine state, a checkpoint
the JAX package wrote restores in the port and continues to the JAX run's
reports, a checkpoint the port wrote restores in the JAX package, and the
port's unpickler refuses a class outside its map.

The JAX side runs its baseline engine; the port runs on the CPU through the
kernels' plain versions, on both of its ingest paths."""
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest

from repro import core as jcore
from repro import stream as jstream
from repro import testing as jtesting
from repro.data import paper_2way as jpaper_2way
from repro_torch import core as tcore
from repro_torch import stream as tstream
from repro_torch import testing as ttesting
from repro_torch.data import paper_2way
from repro_torch.mapreduce import oracle_join
from repro_torch.stream import engine as tengine
from repro_torch.train import checkpoint as tckpt

pytestmark = pytest.mark.faults

_VARIANTS = {"baseline": {}, "fused": dict(fused_ingest=True)}


def _report(r):
    d = dataclasses.asdict(r)
    d.pop("obs")
    return d


def _reports(eng):
    return [_report(r) for r in eng.reports]


def _paper_batches(seed, n):
    rng = np.random.default_rng(seed)
    return [paper_2way(rng, n_r=300, n_s=100, domain=400) for _ in range(n)]


def _zipf_batch(rng, shift, n_r=240, n_s=80, domain=600, a=1.6):
    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _recovery_cfg(pkg, **kw):
    """``tests/test_recovery.py``'s configuration: retention of 4 batches,
    8 hosts."""
    kw.setdefault("recovery", pkg.RecoveryPolicy(n_hosts=8))
    return pkg.StreamConfig(q=60, decay=0.5, load_factor=2.0,
                            retention=pkg.RetentionPolicy(window_batches=4), **kw)


def test_paper_batches_match_reference():
    rng_a, rng_b = np.random.default_rng(12), np.random.default_rng(12)
    for _ in range(2):
        a, b = paper_2way(rng_a, n_r=300, n_s=100, domain=400), jpaper_2way(
            rng_b, n_r=300, n_s=100, domain=400)
        for nm in b:
            np.testing.assert_array_equal(a[nm], b[nm])


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_engine_preempt_mid_batch_checkpoint_resume(tmp_path, variant):
    """Checkpoint, die between batches, restore, and converge to the same
    reports as an uninterrupted run — the port's and the JAX package's."""
    cfg = tstream.StreamConfig(q=60, decay=0.5, load_factor=2.0, **_VARIANTS[variant])
    batches = _paper_batches(12, 6)
    ref = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device="cpu")
    jref = jstream.StreamingJoinEngine(
        jcore.two_way(), jstream.StreamConfig(q=60, decay=0.5, load_factor=2.0))
    for b in batches:
        ref.ingest(b)
        jref.ingest(b)

    eng = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device="cpu")
    for b in batches[:3]:
        eng.ingest(b)
    eng.save_checkpoint(str(tmp_path))
    del eng  # preempted

    resumed = tstream.StreamingJoinEngine.restore(str(tmp_path), tcore.two_way(), cfg,
                                                  device="cpu")
    for b in batches[3:]:
        resumed.ingest(b)
    assert resumed.reports == ref.reports
    assert _reports(resumed) == _reports(jref)
    assert (resumed.total_count, resumed.total_checksum) == (
        jref.total_count, jref.total_checksum)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_fault_injector_active_across_restore_boundary(tmp_path, variant):
    """An injector stays armed across checkpoint/restore and already-fired
    faults do NOT re-fire (sketch faults by the tap's ``first_call``, host
    faults by absolute batch index); the restored run converges to the JAX
    package's uninterrupted run."""
    specs = [
        dict(kind="drop", target="sketch", batch=1),  # pre-kill
        dict(kind="host_loss", target="host", host_id=2, batch=2),
        dict(kind="duplicate", target="sketch", batch=4),  # post-kill
        dict(kind="host_loss", target="host", host_id=5, batch=5),
    ]
    batches = _paper_batches(21, 7)

    jinj = jtesting.FaultInjector([jtesting.FaultSpec(**s) for s in specs])
    jref = jstream.StreamingJoinEngine(jcore.two_way(), jstream.StreamConfig(
        q=60, decay=0.5, load_factor=2.0, recovery=jstream.RecoveryPolicy(n_hosts=8)))
    jref.tracker = jtesting.FaultySketchTap(jref.tracker, jinj)
    jref.arm_faults(jinj)
    for b in batches:
        jref.ingest(b)
    assert [r.batch for r in jref.recoveries] == [2, 5]

    cfg = tstream.StreamConfig(q=60, decay=0.5, load_factor=2.0,
                               recovery=tstream.RecoveryPolicy(n_hosts=8),
                               **_VARIANTS[variant])
    inj = ttesting.FaultInjector([ttesting.FaultSpec(**s) for s in specs])
    eng = tstream.StreamingJoinEngine(tcore.two_way(), cfg, device="cpu")
    eng.tracker = ttesting.FaultySketchTap(eng.tracker, inj)
    eng.arm_faults(inj)
    for b in batches[:3]:  # batch-1 sketch fault and batch-2 loss fire
        eng.ingest(b)
    assert len(eng.recoveries) == 1
    eng.save_checkpoint(str(tmp_path))
    del eng  # killed

    resumed = tstream.StreamingJoinEngine.restore(str(tmp_path), tcore.two_way(), cfg,
                                                  device="cpu")
    resumed.tracker = ttesting.FaultySketchTap(
        resumed.tracker, inj, first_call=len(resumed.reports))
    resumed.arm_faults(inj)  # SAME injector: its event log survives
    for b in batches[3:]:
        resumed.ingest(b)
    assert [r.batch for r in resumed.recoveries] == [2, 5]
    assert inj.report().sketch_tampered == 2  # batch 1 once, batch 4 once
    inj.resolve([])
    inj.assert_all_resolved()
    assert _reports(resumed) == _reports(jref)
    assert [dataclasses.asdict(r) for r in resumed.recoveries] == [
        dataclasses.asdict(r) for r in jref.recoveries]
    count, checksum, _, _ = oracle_join(tcore.two_way(), resumed.history_data())
    assert (resumed.total_count, resumed.total_checksum) == (count, checksum)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_recovery_state_survives_checkpoint(tmp_path, variant):
    """Recovery history, host liveness and admission capacity round-trip
    through save/restore; the restored engine streams on in lockstep with
    the saving one and with the JAX package's engine."""
    rng = np.random.default_rng(9)
    batches = [_zipf_batch(rng, 0) for _ in range(9)]

    def cfg(pkg, **kw):
        return _recovery_cfg(pkg, admission=pkg.AdmissionPolicy(headroom=4.0),
                             recovery=pkg.RecoveryPolicy(n_hosts=8, degrade_below=0.9), **kw)

    jeng = jstream.StreamingJoinEngine(jcore.two_way(), cfg(jstream))
    eng = tstream.StreamingJoinEngine(tcore.two_way(), cfg(tstream, **_VARIANTS[variant]),
                                      device="cpu")
    for b in batches[:5]:
        eng.ingest(b)
        jeng.ingest(b)
    rep = eng.fail_hosts([0, 1])  # 6/8 < 0.9 -> degrade, capacity clamped
    assert rep.mode == "degrade"
    assert dataclasses.asdict(rep) == dataclasses.asdict(jeng.fail_hosts([0, 1]))
    eng.save_checkpoint(str(tmp_path))
    resumed = tstream.StreamingJoinEngine.restore(
        str(tmp_path), tcore.two_way(), cfg(tstream, **_VARIANTS[variant]), device="cpu")
    assert resumed.recoveries == eng.recoveries
    assert resumed.total_replayed == eng.total_replayed
    assert resumed._hosts.alive == eng._hosts.alive
    assert resumed._slots_per_host == eng._slots_per_host
    assert resumed._controller.capacity_factor == pytest.approx(6 / 8)
    for b in batches[5:]:
        assert resumed.ingest(b) == eng.ingest(b)
        jeng.ingest(b)
    assert _reports(resumed) == _reports(jeng)
    assert (resumed.window_count, resumed.window_checksum) == (
        jeng.window_count, jeng.window_checksum)


def test_pre_recovery_checkpoint_restores_with_recovery_on(tmp_path):
    """A checkpoint written with recovery off restores into a
    recovery-enabled engine: hosts are assigned fresh and the engine can
    immediately survive a loss, as the JAX package's does."""
    rng = np.random.default_rng(10)
    batches = [_zipf_batch(rng, 0) for _ in range(5)]
    out = []
    for pkg, core, kw, path in [(tstream, tcore, dict(device="cpu"), tmp_path / "port"),
                                (jstream, jcore, {}, tmp_path / "jax")]:
        eng = pkg.StreamingJoinEngine(
            core.two_way(), _recovery_cfg(pkg, recovery=pkg.RecoveryPolicy()), **kw)
        for b in batches:
            eng.ingest(b)
        eng.save_checkpoint(str(path))
        resumed = pkg.StreamingJoinEngine.restore(str(path), core.two_way(),
                                                  _recovery_cfg(pkg), **kw)
        assert resumed._hosts.host_of.size == resumed.plan.total_reducers
        rep = resumed.fail_hosts([0])
        assert rep is not None and rep.verified
        out.append(dataclasses.asdict(rep))
    assert out[0] == out[1]


def _bounded_recovered_engines(variant):
    """A JAX and a port engine after the same six batches, one replay
    recovery and an admission backlog: every part of the checkpoint tree is
    present."""
    rng = np.random.default_rng(31)
    batches = [_zipf_batch(rng, 0 if i < 3 else 300, n_r=400) for i in range(6)]

    def cfg(pkg, **kw):
        return _recovery_cfg(pkg, admission=pkg.AdmissionPolicy(headroom=0.5,
                                                                 max_backlog_rows=200,
                                                                 min_admit=16), **kw)

    jeng = jstream.StreamingJoinEngine(jcore.two_way(), cfg(jstream))
    teng = tstream.StreamingJoinEngine(tcore.two_way(), cfg(tstream, **_VARIANTS[variant]),
                                       device="cpu")
    for b in batches:
        jeng.ingest(b)
        teng.ingest(b)
    jeng.fail_hosts([4])
    teng.fail_hosts([4])
    return jeng, teng, cfg, rng


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_manifests_match_reference(tmp_path, variant):
    """The same engine state gives the same manifest keys, shapes and dtypes
    in both packages (the pickled blobs' lengths differ: the packages pickle
    with different protocols)."""
    jeng, teng, _, _ = _bounded_recovered_engines(variant)
    assert teng.total_deferred + teng.total_shed > 0 and teng.recoveries
    mans = []
    for eng, path in [(jeng, tmp_path / "jax"), (teng, tmp_path / "port")]:
        final = eng.save_checkpoint(str(path))
        assert os.path.basename(final) == f"step_{len(eng.reports):08d}"
        assert (path / "LATEST").read_text() == os.path.basename(final)
        mans.append(json.loads((Path(final) / "manifest.json").read_text()))
    want, got = mans
    assert got["keys"] == want["keys"]
    assert {"blob", "recovery_blob", "hosts/host_of", "recovery_scalars",
            "tracker/batches", "history/S/000003"} <= set(got["keys"])
    assert any(k.startswith("admission/") for k in got["keys"])
    blobs = {"blob", "recovery_blob"}
    for field in ("shapes", "dtypes"):
        assert {k: v for k, v in got[field].items() if k not in blobs} == {
            k: v for k, v in want[field].items() if k not in blobs}
    assert got["dtypes"]["blob"] == want["dtypes"]["blob"] == "uint8"
    assert got["step"] == want["step"] and got["metadata"] == want["metadata"]
    _, tflat = tckpt.load_checkpoint(str(tmp_path / "port"))
    from repro.train.checkpoint import load_checkpoint as jload

    _, jflat = jload(str(tmp_path / "jax"))
    for k in jflat:
        if k not in blobs | {"batch_ages", "scalars"}:  # ages are wall clock
            np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
    # the last scalar counts fused batches: the JAX run is its baseline
    np.testing.assert_array_equal(tflat["scalars"][:-1], jflat["scalars"][:-1])
    assert tflat["scalars"][-1] == teng.fused_batches


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_jax_checkpoint_restores_in_the_port(tmp_path, variant):
    """A checkpoint the JAX package wrote (recovery, admission, retention)
    restores in the port and continues to the JAX package's uninterrupted
    reports, window fingerprint and recoveries."""
    jeng, _, cfg, rng = _bounded_recovered_engines(variant)
    jeng.save_checkpoint(str(tmp_path))
    more = [_zipf_batch(rng, 300, n_r=400) for _ in range(3)]
    resumed = tstream.StreamingJoinEngine.restore(
        str(tmp_path), tcore.two_way(), cfg(tstream, **_VARIANTS[variant]), device="cpu")
    assert type(resumed.plan) is tcore.SharesSkewPlan
    assert all(type(r) is tstream.BatchReport for r in resumed.reports)
    assert all(type(r) is tstream.RecoveryReport for r in resumed.recoveries)
    for i, b in enumerate(more):
        if i == 1:
            assert dataclasses.asdict(resumed.fail_hosts([6])) == dataclasses.asdict(
                jeng.fail_hosts([6]))
        assert _report(resumed.ingest(b)) == _report(jeng.ingest(b))
    assert _reports(resumed) == _reports(jeng)
    assert [dataclasses.asdict(r) for r in resumed.recoveries] == [
        dataclasses.asdict(r) for r in jeng.recoveries]
    count, checksum, _, _ = oracle_join(tcore.two_way(), resumed.history_data())
    assert (resumed.window_count, resumed.window_checksum) == (count, checksum)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_port_checkpoint_restores_in_jax(tmp_path, variant):
    """A checkpoint the port wrote restores in the JAX package, whose
    ``restore`` reads the pickled plan and reports with plain
    ``pickle.loads``: they name the JAX package's classes.  The JAX engine
    then continues to the port's own reports and recoveries."""
    _, teng, cfg, rng = _bounded_recovered_engines(variant)
    teng.save_checkpoint(str(tmp_path))
    more = [_zipf_batch(rng, 300, n_r=400) for _ in range(3)]
    resumed = jstream.StreamingJoinEngine.restore(str(tmp_path), jcore.two_way(), cfg(jstream))
    assert type(resumed.plan) is jcore.SharesSkewPlan
    assert all(type(r) is jstream.BatchReport for r in resumed.reports)
    assert all(type(r) is jstream.RecoveryReport for r in resumed.recoveries)
    assert _reports(resumed) == _reports(teng)
    for i, b in enumerate(more):
        if i == 1:
            assert dataclasses.asdict(resumed.fail_hosts([6])) == dataclasses.asdict(
                teng.fail_hosts([6]))
        assert _report(resumed.ingest(b)) == _report(teng.ingest(b))
    assert [dataclasses.asdict(r) for r in resumed.recoveries] == [
        dataclasses.asdict(r) for r in teng.recoveries]


def test_blob_names_only_the_mapped_classes():
    """The port's blobs name ``repro.*`` for its mapped classes, read back
    through its own unpickler, and refuse any other class of the port."""
    blob = tengine._pickle_blob((tcore.two_way(), [np.int64(3)], {"a": np.arange(2)}))
    text = blob.tobytes()
    assert b"crepro.core.schema\nJoinQuery\n" in text and b"repro_torch" not in text
    back = tengine._unpickle(blob)
    assert type(back[0]) is tcore.JoinQuery and back[0] == tcore.two_way()
    assert pickle.loads(text)[0] == jcore.two_way()
    with pytest.raises(TypeError, match="cannot hold"):
        tengine._pickle_blob(tstream.StreamConfig(q=60))


def test_port_reads_jax_checkpoint_without_jax(tmp_path):
    """In a process where JAX cannot import, the port restores a JAX
    checkpoint and loads no ``repro`` module doing it."""
    jeng, _, _, _ = _bounded_recovered_engines("baseline")
    jeng.save_checkpoint(str(tmp_path))
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch import core, stream\n"
        "cfg = stream.StreamConfig(q=60, decay=0.5, load_factor=2.0,\n"
        "    retention=stream.RetentionPolicy(window_batches=4),\n"
        "    recovery=stream.RecoveryPolicy(n_hosts=8),\n"
        "    admission=stream.AdmissionPolicy(headroom=0.5, max_backlog_rows=200, min_admit=16))\n"
        f"eng = stream.StreamingJoinEngine.restore({str(tmp_path)!r}, core.two_way(), cfg,\n"
        "                                           device='cpu')\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n"
        "print(len(eng.reports), eng.window_count, len(eng.recoveries))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(jeng.reports)), str(jeng.window_count),
                                  str(len(jeng.recoveries))]


def test_unpickler_refuses_classes_outside_its_map():
    ok = tengine._unpickle(np.frombuffer(pickle.dumps(
        (tcore.two_way(), {1, 2}, np.arange(3), frozenset())), dtype=np.uint8))
    assert type(ok[0]) is tcore.JoinQuery and ok[1] == {1, 2}
    scalars = (np.int64(7), np.float32(1.5), np.arange(4, dtype=np.int32).reshape(2, 2),
               np.dtype("int16"))
    got = tengine._unpickle(np.frombuffer(pickle.dumps(scalars), dtype=np.uint8))
    assert all(type(g) is type(w) and np.array_equal(g, w) for g, w in zip(got, scalars))
    for obj in (OrderedDict(a=1), print, tengine._PortUnpickler):
        blob = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        with pytest.raises(pickle.UnpicklingError, match="does not read"):
            tengine._unpickle(blob)
    u = tengine._PortUnpickler(io.BytesIO())
    assert u.find_class("repro.core.schema", "JoinQuery") is tcore.JoinQuery
    assert u.find_class("repro.stream.engine", "BatchReport") is tstream.BatchReport
    assert u.find_class("numpy.dtypes", "Int64DType") is np.dtypes.Int64DType
    for module, name in [("repro.core.schema", "two_way"), ("repro.nowhere", "X"),
                         ("repro.core.schema", "NoSuchClass"), ("builtins", "eval"),
                         ("os", "system"), ("repro_torch", "X"), ("numpy", "load"),
                         ("numpy.ctypeslib", "load_library"), ("numpy.dtypes", "np"),
                         ("numpy._core.multiarray", "frombuffer")]:
        with pytest.raises(pickle.UnpicklingError, match="does not read"):
            u.find_class(module, name)


def test_flatten_matches_jax_tree_paths():
    """The port's flattening gives ``jax.tree_util``'s keys, in its order."""
    import jax

    tree = {"b": [np.zeros(2), {"z": np.ones(1), "a": np.arange(3)}],
            "a": (np.int64(4), None, np.float32(1.5)), "c": {"x/y": np.eye(2)}, "d": None,
            "e": []}
    want = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        want.append((key, np.asarray(leaf)))
    got = list(tckpt._flatten_with_paths(tree).items())
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_checkpoint_gc_and_latest(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(d)
    for step in range(5):
        tckpt.save_checkpoint(d, step, {"x": np.full(2, step)}, keep=2, metadata={"s": step})
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003", "step_00000004"]
    assert tckpt.latest_step(d) == 4
    step, flat = tckpt.load_checkpoint(d, 3)
    assert step == 3 and flat["x"].tolist() == [3, 3]
    assert tckpt.load_manifest(d)["metadata"] == {"s": 4}
    with pytest.raises(ValueError, match="not filename-safe"):
        tckpt.tenant_checkpoint_dir(d, "../x")
    with pytest.raises(ValueError, match="reserved"):
        tckpt.tenant_checkpoint_dir(d, "LATEST")
    assert tckpt.tenant_checkpoint_dir(d, "q1") == os.path.join(d, "tenant_q1")
