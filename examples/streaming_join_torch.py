"""Streaming SharesSkew on PyTorch: join a drifting Zipf stream on the card.

The twin of ``examples/streaming_join.py``'s single-query run, through the
port (``repro_torch``): the same 2-way join R(A,B) ⋈ S(B,C), the same
micro-batches from the same seeds, whose heavy B values move mid-run.  The
sketches notice the new heavy hitters, the drift monitor declares the
running plan overloaded and a replan migrates the carried state.  The final
(count, checksum) is verified against the port's batch oracle.

The loop runs under ``train.elastic.PreemptionGuard``: a SIGTERM mid-stream
is caught at the next batch boundary, the engine writes a checkpoint with
``save_checkpoint`` and the process exits cleanly; rerunning with the same
``--ckpt-dir`` restores the engine and finishes the remaining batches with
bit-identical fingerprints.

``--kill-reducer H`` demos in-flight reducer-loss recovery instead:
reducers multiplex over 8 simulated hosts, host H is killed right after the
drift, and the engine recovers at that batch boundary by lineage replay
from the retained window, then verifies the window fingerprint (the
block-join kernel on the card).

``--trace out.json`` records the run as nested spans and writes Chrome
trace-event JSON loadable in Perfetto (https://ui.perfetto.dev).

``--queries N`` demos the multi-tenant engine: N copies of the query run
behind ONE shared sketch ingest per relation batch (the Count-Min kernel on
the card).  A poison-pill batch is injected into tenant q1 mid-run — the
circuit breaker quarantines it while every other tenant stays
bit-identical to a single-tenant run (verified against the oracle at the
end).

``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/streaming_join_torch.py
      PYTHONPATH=src python examples/streaming_join_torch.py --ckpt-dir /tmp/sj
      (send it SIGTERM mid-stream, then rerun the same command to resume)
      PYTHONPATH=src python examples/streaming_join_torch.py --kill-reducer 2
      PYTHONPATH=src python examples/streaming_join_torch.py --kill-reducer 2 --trace trace.json
      PYTHONPATH=src python examples/streaming_join_torch.py --queries 3
"""
import argparse
import sys

import numpy as np

from repro_torch.core import two_way
from repro_torch.mapreduce import oracle_join
from repro_torch.stream import (
    MultiQueryEngine,
    ObsPolicy,
    RecoveryPolicy,
    RetentionPolicy,
    StreamConfig,
    StreamingJoinEngine,
    TenancyPolicy,
    TenantSpec,
)
from repro_torch.testing import FaultInjector, FaultSpec
from repro_torch.train import PreemptionGuard, latest_step

N_BATCHES = 8


def zipf_batch(rng, shift, n_r=1200, n_s=300, domain=3000, a=1.6):
    """One micro-batch; heavy B values cluster at ``shift`` (mod domain)."""
    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def multi_query_demo(n_queries: int, device: str, trace: str | None = None) -> int:
    """N tenants, one shared sketch ingest, poison-pill containment."""
    query = two_way()
    config = StreamConfig(q=120, decay=0.5, load_factor=2.0)
    tenants = [
        TenantSpec(f"q{i}", query, config, weight=1.0 + (i == 0))
        for i in range(n_queries)
    ]
    policy = TenancyPolicy(
        obs=ObsPolicy(trace=True, metrics=True) if trace else ObsPolicy()
    )
    mq = MultiQueryEngine(tenants, policy, log_fn=print, device=device)
    inj = FaultInjector(
        [FaultSpec(kind="poison_rows", target="tenant", tenant="q1",
                   batch=4, poison="nan")]
    )
    mq.arm_faults(inj)
    print(f"streaming {query} for {n_queries} tenants; "
          f"poison-pill hits q1 at batch 4\n")

    rngs = [np.random.default_rng(0)]
    for _ in range(N_BATCHES):
        rngs.append(np.random.default_rng(rngs[-1].integers(2**63)))
    history: list[dict] = []
    for i in range(N_BATCHES):
        shift = 0 if i < 4 else 1300
        batch = zipf_batch(rngs[i], shift)
        history.append(batch)
        mq.ingest(batch)
        states = {nm: st.state for nm, st in mq.status().items()}
        if states.get("q1") != "RUNNING":
            print(f"  batch {i}: q1 is {states['q1']} "
                  f"(others: {sorted(set(states[n] for n in states if n != 'q1'))})")

    full = {
        nm: np.concatenate([b[nm] for b in history]) for nm in history[0]
    }
    count, checksum, _, _ = oracle_join(query, full)
    # q1 took the poison pill: it was quarantined, reopened, and skipped
    # the quarantine window — the isolation contract is about everyone ELSE
    clean = [nm for nm in mq.status() if nm != "q1"]
    for nm in clean:
        eng = mq.engine(nm)
        assert (eng.total_count, eng.total_checksum) == (count, checksum), nm
        assert eng.sketch_ingest_calls == 0, nm  # never computed privately
    q1 = mq.engine("q1")
    assert q1.total_count < count  # it really did miss batches
    inj.assert_all_resolved()
    rep = inj.report()
    print(f"\ntenants: {dict(sorted((nm, st.state) for nm, st in mq.status().items()))}")
    print(f"shared sketch passes: {mq.shared_sketch_passes} "
          f"(vs {mq.shared_sketch_passes * n_queries} for {n_queries} "
          f"separate engines); contained faults: {rep.contained}")
    print(f"verified: every unaffected tenant bit-identical to the oracle "
          f"({count} results, checksum {checksum:#010x}); q1 skipped its "
          f"quarantine window ({q1.total_count} results)")
    if trace:
        mq.obs.tracer.dump(trace)
        print(f"wrote {len(mq.obs.tracer.to_chrome()['traceEvents'])} trace "
              f"events to {trace} (load in https://ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint directory; enables SIGTERM-safe resume")
    parser.add_argument("--kill-reducer", type=int, default=None, metavar="HOST",
                        help="kill this reducer host (0-7) right after the drift and "
                        "recover in-flight by lineage replay")
    parser.add_argument("--trace", default=None, metavar="OUT_JSON",
                        help="enable the observability layer and write the run as "
                        "Chrome/Perfetto trace-event JSON")
    parser.add_argument("--queries", type=int, default=None, metavar="N",
                        help="run N tenant queries behind one shared sketch ingest and "
                        "demo poison-pill containment")
    parser.add_argument("--device", default="cuda",
                        help="where the engine runs (default: cuda)")
    args = parser.parse_args(argv)

    if args.queries is not None:
        if args.queries < 2:
            parser.error("--queries needs N >= 2")
        return multi_query_demo(args.queries, args.device, trace=args.trace)

    query = two_way()
    obs = (ObsPolicy(trace=True, metrics=True, skewscope=True) if args.trace
           else ObsPolicy())
    if args.kill_reducer is not None:
        # the recovery demo needs the host model + a retained window to
        # replay lost reducer state from
        config = StreamConfig(
            q=120, decay=0.5, load_factor=2.0,
            retention=RetentionPolicy(window_batches=4),
            recovery=RecoveryPolicy(n_hosts=8), obs=obs,
        )
    else:
        config = StreamConfig(q=120, decay=0.5, load_factor=2.0, obs=obs)

    start_batch = 0
    if args.ckpt_dir is not None and latest_step(args.ckpt_dir) is not None:
        engine = StreamingJoinEngine.restore(args.ckpt_dir, query, config, log_fn=print,
                                             device=args.device)
        start_batch = len(engine.reports)
        print(f"resumed from checkpoint at batch {start_batch}\n")
    else:
        engine = StreamingJoinEngine(query, config, log_fn=print, device=args.device)
        print(f"streaming {query} with a skew shift after batch 3\n")
    print(f"device: {engine.device}")

    # the batch stream is a pure function of the batch index, so a resumed
    # run regenerates exactly the batches the interrupted run never ingested
    rngs = [np.random.default_rng(0)]
    for _ in range(N_BATCHES):
        rngs.append(np.random.default_rng(rngs[-1].integers(2**63)))

    with PreemptionGuard() as guard:
        for i in range(start_batch, N_BATCHES):
            shift = 0 if i < 4 else 1300  # the drift: heavy values move
            report = engine.ingest(zipf_batch(rngs[i], shift))
            if report.replanned and report.batch > 0:
                print(f"  >>> REPLAN (epoch {report.plan_epoch}): {report.drift_reason}; "
                      f"migrated {report.migrated_tuples} emissions")
            if args.kill_reducer is not None and i == 5:
                print(f"  >>> KILLING host {args.kill_reducer}")
                rec = engine.fail_hosts([args.kill_reducer])
                if rec is not None:
                    print(f"  >>> RECOVERED ({rec.mode}): {rec.lost_reducers} reducer(s) "
                          f"lost, replayed {rec.replayed_tuples}/{rec.lost_share_tuples} "
                          f"lineage tuples from {rec.batches_replayed} retained batches, "
                          f"survivors {rec.survivors}/8, verified={rec.verified}")
            if guard.should_stop:
                if args.ckpt_dir is None:
                    print("\npreempted (no --ckpt-dir): stopping cleanly")
                    return 1
                path = engine.save_checkpoint(args.ckpt_dir)
                print(f"\npreempted at batch {report.batch}: checkpointed to {path}; "
                      "rerun to resume")
                return 0

    print(f"\nreplans: {engine.replan_count}, cumulative comm: {engine.cumulative_comm} "
          f"tuples, migrated: {engine.total_migrated}")

    count, checksum, _, _ = oracle_join(query, engine.history_data())
    if args.kill_reducer is not None:
        # retention is on in the recovery demo: the exactness contract is
        # the retained-window fingerprint
        assert (engine.window_count, engine.window_checksum) == (count, checksum)
        print(f"verified on {engine.device}: post-recovery window count/checksum == "
              f"oracle on the retained window ({count} results, checksum {checksum:#010x})")
    else:
        assert (engine.total_count, engine.total_checksum) == (count, checksum)
        print(f"verified on {engine.device}: cumulative count/checksum == batch oracle "
              f"({count} results, checksum {checksum:#010x})")
    if args.trace:
        engine.obs.tracer.dump(args.trace)
        skew = engine.skew_report()
        print(f"wrote {len(engine.obs.tracer.to_chrome()['traceEvents'])} trace events to "
              f"{args.trace} (load in https://ui.perfetto.dev); reducer imbalance "
              f"{skew.imbalance:.2f}x, HH hit rate {skew.hh_hit_rate:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
