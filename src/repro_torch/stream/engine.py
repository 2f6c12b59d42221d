"""Streaming SharesSkew on PyTorch: stateful micro-batch join executor
(DESIGN.md §6), the port of ``repro.stream.engine``.

Semantics: after ingesting batches 1..T the engine has produced exactly the
join of the concatenated input — same (count, checksum) fingerprint as
``mapreduce.run_join`` / ``oracle_join`` on the concatenation — while each
batch only ships its *new* tuples through the map phase (symmetric multiway
hash join: reducers keep what they received; history is never re-shuffled
except when a drift replan changes the reducer layout, which is a counted
state migration).

Per batch:
  1. admission control (``stream.admission``, optional): the backlog and
     the incoming batch are admitted up to a budget derived from the plan's
     ``q`` and the live sketch; the rest is deferred or shed with exact
     counters (``BatchReport.deferred/shed``);
  2. windowed retention (``stream.retention``, optional): batches that
     left the retained window are *retracted* — their contribution is
     subtracted from the window fingerprint via the same telescoping
     identity used for insertion, and their tuples leave carried state
     with a prefix shift (no shuffle);
  3. sketches observe the batch (``StreamHHTracker``, optionally through
     the ``kernels.cms_update`` CUDA kernel);
  4. the ``DriftMonitor`` re-evaluates the running plan's cost model
     against the live sketch; on drift, ``plan_with_hh`` installs a fresh
     plan and accumulated state is re-routed under it (migration);
  5. new tuples are routed on the engine's device with
     ``mapreduce.keys.map_phase`` — the same vectorized recursive_keys the
     batch executor uses — and binned per reducer;
  6. the join delta is the n-term telescoping expansion
     Δ(R_1 ⋈ ... ⋈ R_n) = Σ_i  R_1^all ⋈ ... ⋈ R_{i-1}^all ⋈ ΔR_i
                                ⋈ R_{i+1}^old ⋈ ... ⋈ R_n^old
     evaluated with ``mapreduce.local_join.local_join_count_checksum`` on
     the device over (old | new | merged) per-reducer bins (the block-join
     kernel for binary joins), so counts and orderless checksums
     accumulate associatively mod 2^32; counts are summed in int64.

With ``StreamConfig(fused_ingest=True)`` (DESIGN.md §7) steps 3 and 5 run
as ONE pass per relation through ``kernels.ingest_fused`` (destinations +
sketch increment + pack plan), and step 6's terms use the sorted merge join
of ``stream.delta`` for binary single-column queries.  Every fused-path
result is bit-identical to this baseline, which stays in the tree as the
correctness oracle.

With ``StreamConfig(recovery=RecoveryPolicy(n_hosts=H))`` (DESIGN.md §5)
reducers multiplex over H simulated hosts; a host lost to ``fail_hosts`` or
to an armed ``testing.faults.FaultInjector`` is detected at the next batch
boundary and recovered by lineage replay from the retained window (or, under
sustained loss, by ``core.planner.repair_plan`` and a rebuild), then
verified against the window fingerprint on the device.

``save_checkpoint()`` / ``restore()`` serialize sketches, incumbent plan,
drift-monitor state, retained history, window clock, admission backlog and
recovery state through ``train.checkpoint`` (atomic step dirs + LATEST
pointer) in the JAX package's layout and keys, so a preempted engine resumes
mid-stream to the same reports, and a checkpoint the JAX package wrote
restores here (its pickled plan and reports are read through
``_PortUnpickler``); the port pickles them under the JAX package's class
names (``_pickle_blob``), so a checkpoint written here restores there too.

Under a ``repro_torch.stream.tenancy.MultiQueryEngine`` the engine is one
tenant: it takes the shared ``obs`` facade's tenant view, and ``ingest``
absorbs the Count-Min increments that the shared pass computed once for
every tenant (``shared_deltas``) in place of its own sketch pass.

The binned state, the sorted delta index and the sketches live on the host
in numpy, as in the reference; the device runs routing, the fused pass and
the delta joins.  ``device`` defaults to ``"cuda"`` and raises without a
card; ``device="cpu"`` runs the kernels' plain versions.
``recompute_distributed`` replays the retained input through the
distributed shuffle (``mapreduce.shuffle.run_distributed``) on the same
device.
"""
from __future__ import annotations

import dataclasses
import importlib
import io
import os
import pickle
import pickletools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.planner import SharesSkewPlan, plan_with_hh, repair_plan
from repro_torch.core.schema import JoinQuery
from repro_torch.kernels.ingest_fused import (
    DenseRoutes,
    dense_route_encoding,
    fused_ingest,
    fused_ingest_dense,
    pack_routes,
    route_width,
)
from repro_torch.mapreduce.executor import _device
from repro_torch.mapreduce.keys import map_phase, static_route_table
from repro_torch.mapreduce.local_join import LocalJoinSpec, local_join_count_checksum
from repro_torch.mapreduce.shuffle import run_distributed
from repro_torch.mapreduce.straggler import FailureDetector
from repro_torch.obs import NULL_OBS, Observability, ObsPolicy, cms_window_error, hh_hit_counts
from repro_torch.testing.faults import FaultInjector
from repro_torch.train import checkpoint
from repro_torch.train.elastic import plan_mesh_shape

from .admission import AdmissionController, AdmissionPolicy
from .delta import SortedDeltaIndex
from .drift import DriftDecision, DriftMonitor
from .recovery import (
    HostTracker,
    RecoveryExhaustedError,
    RecoveryPolicy,
    RecoveryReport,
    record_recovery,
)
from .retention import (
    RetentionPolicy,
    carried_tuples,
    lost_occupancy,
    remove_prefix,
    select_reducers,
    zero_reducers,
)
from .sketch import StreamHHTracker

_MASK32 = 0xFFFFFFFF

CHECKPOINT_FORMAT = 1  # bump on any layout change; restore() validates it


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Tuning knobs for the streaming engine."""

    q: float  # per-reducer capacity the plans are solved for
    hh_threshold: float | None = None  # per-batch HH rate threshold (default q)
    decay: float = 0.5  # sketch EMA decay per batch
    sketch_width: int = 2048
    sketch_depth: int = 4
    ss_capacity: int = 64
    max_hh_per_attr: int = 8
    comm_factor: float = 1.5  # comm drift trigger
    load_factor: float = 3.0  # overload drift trigger
    fade_factor: float = 0.25  # wasted-replication (faded pin) drift trigger
    cooldown: int = 1  # batches after a replan during which drift is ignored
    use_device_sketch: bool = False  # route CMS updates through the CUDA kernel
    sketch_seed: int = 0
    # Fused ingest (DESIGN.md §7): one kernel pass per relation computes
    # map-phase destinations, the Count-Min increment, and the pack plan
    # (per-reducer counts + in-destination ranks).  Bit-identical to the
    # baseline path, which remains the correctness oracle.
    fused_ingest: bool = False
    # The TPU kernel's tuple block and DMA double buffering.  Kept so a
    # config means the same to both packages; the CUDA pass picks its own
    # tiling and reads neither.
    fused_block: int = 256
    fused_double_buffer: bool = True
    # Route the fused pass through the dense route encoding (the routes as
    # data, padded to a power-of-two width per relation) instead of the
    # static table.  Both run the same kernel; bit-identical either way.
    fused_dynamic_routes: bool = True
    # Bounded state (DESIGN.md §8): both default to off, reproducing the
    # unbounded §6 baseline bit-for-bit.
    retention: RetentionPolicy = RetentionPolicy()
    admission: AdmissionPolicy = AdmissionPolicy()
    # Reducer-loss recovery (DESIGN.md §5): off by default; with
    # ``RecoveryPolicy(n_hosts=H)`` reducers multiplex over H simulated
    # hosts, host loss is detected by heartbeat deadline and recovered by
    # lineage replay / plan repair at batch boundaries.
    recovery: RecoveryPolicy = RecoveryPolicy()
    # Observability (DESIGN.md §10): spans, metrics, per-reducer load
    # telemetry.  All off by default — disabled hooks are free.
    obs: ObsPolicy = ObsPolicy()


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """Telemetry for one ingested micro-batch."""

    batch: int  # 0-based batch index
    plan_epoch: int  # increments at every replan
    replanned: bool
    drift_reason: str  # why the replan fired ("" otherwise)
    delta_count: int  # join results contributed by this batch
    total_count: int  # cumulative join count
    total_checksum: int  # cumulative orderless checksum (mod 2^32)
    comm_tuples: dict[str, int]  # new tuples shipped this batch, per relation
    cumulative_comm: int  # all new-tuple shipments so far (excl. migration)
    migrated_tuples: int  # state re-routed by this batch's replan (0 if none)
    max_load: int  # worst per-reducer arrivals this plan epoch
    hh_values: dict[str, list[int]]  # live plan's pinned HH set
    # bounded-state telemetry (DESIGN.md §8); zeros when retention and
    # admission are off
    deferred: dict[str, int]  # rows queued in the backlog after this batch
    shed: dict[str, int]  # rows dropped by admission this batch
    expired_batches: int  # batches retired from the window this ingest
    retracted_count: int  # join results retracted from the window fingerprint
    window_count: int  # fingerprint of the retained window (== total_* when
    window_checksum: int  # retention is off)
    carried_tuples: int  # retained emissions across all reducers/relations
    max_carried: int  # worst per-reducer retained occupancy
    # drift-trigger telemetry (DESIGN.md §10): which drift check fired the
    # replan and the observed-vs-threshold pair behind it.  "initial" for
    # the first plan; "" when this batch did not replan.
    drift_trigger: str = ""
    drift_observed: float = 0.0
    drift_threshold: float = 0.0
    # observability payload (metrics snapshot + skew snapshot) — excluded
    # from equality: histogram sums carry wall time, and the baseline-vs-
    # fused parity assertions compare everything else bit-for-bit
    obs: dict | None = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def total_comm(self) -> int:
        return int(sum(self.comm_tuples.values()))


def _group_np(
    dest: np.ndarray, rows: np.ndarray, k: int, cap: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact host-side group_by_reducer (no capacity drops; cap must cover
    the true max occupancy).  Returns (bins [k, cap, arity], valid [k, cap])."""
    arity = rows.shape[1]
    bins = np.zeros((k, cap, arity), dtype=np.int32)
    valid = np.zeros((k, cap), dtype=bool)
    if dest.size:
        order = np.argsort(dest, kind="stable")
        ds, rs = dest[order], rows[order]
        first = np.searchsorted(ds, ds, side="left")
        rank = (np.arange(ds.size) - first).astype(np.int64)
        bins[ds, rank] = rs
        valid[ds, rank] = True
    return bins, valid


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class _Routed:
    """One relation's routed batch: the valid emissions after map_phase.

    ``rank`` (fused path only) is each emission's arrival index within its
    destination — the kernel's pack plan, which turns every downstream
    grouping into a precomputed-index scatter.  ``counts`` is the
    per-reducer arrival histogram (= ``np.bincount(dest, minlength=k)``).
    """

    dest: np.ndarray  # [E] int32 reducer ids (valid only)
    rows: np.ndarray  # [E, arity] int32
    rank: np.ndarray | None  # [E] in-destination ranks, None on baseline
    counts: np.ndarray  # [k] int64 arrivals per reducer


class StreamingJoinEngine:
    """Online SharesSkew join over an unbounded micro-batch sequence."""

    def __init__(
        self,
        query: JoinQuery,
        config: StreamConfig,
        log_fn: Callable[[str], None] | None = None,
        clock: Callable[[], float] | None = None,
        device: str | torch.device = "cuda",
        obs: Observability | None = None,
    ):
        self.query = query
        self.config = config
        self.device = _device(device)
        self.spec = LocalJoinSpec.from_query(query)
        # observability facade: an injected one (MultiQueryEngine hands each
        # tenant a labeled view of SHARED tracer+registry) wins; otherwise
        # built from config.obs; NULL_OBS keeps every hook free when off
        arities = {r.name: r.arity for r in query.relations}
        if obs is not None:
            self.obs = obs
        elif config.obs.any:
            self.obs = Observability(config.obs, arities=arities)
        else:
            self.obs = NULL_OBS
        self.tracker = StreamHHTracker(
            query,
            width=config.sketch_width,
            depth=config.sketch_depth,
            capacity=config.ss_capacity,
            decay=config.decay,
            seed=config.sketch_seed,
            use_device_sketch=config.use_device_sketch,
            device=self.device,
        )
        self.monitor = DriftMonitor(
            config.q,
            comm_factor=config.comm_factor,
            load_factor=config.load_factor,
            fade_factor=config.fade_factor,
            cooldown=config.cooldown,
        )
        self.plan: SharesSkewPlan | None = None
        self.plan_epoch = -1
        self._log = log_fn or (lambda _msg: None)
        self._clock = clock or time.monotonic

        # retained raw history (per relation, one entry per retained batch)
        # for replan migration; with retention on, expired batches are
        # dropped so migration re-routes the retained suffix only
        self._history: dict[str, list[np.ndarray]] = {
            r.name: [] for r in query.relations
        }
        # window bookkeeping, aligned with _history entries
        self._retained_ids: list[int] = []  # batch indices still retained
        self._batch_ts: list[float] = []  # ingest clock per retained batch
        # per-batch routed emissions under the CURRENT plan — kept only
        # when retention is on (retraction needs them); rebuilt at replans
        self._routed_log: dict[str, list[_Routed]] = {
            r.name: [] for r in query.relations
        }
        # carried reducer state under the CURRENT plan, kept binned:
        # name -> (bins [k, cap, arity], valid [k, cap], occup [k]).
        # Appending a batch is a host-side scatter at rank offsets — never a
        # re-sort of history, and no per-shape device op churn; only a
        # replan rebuilds from scratch.
        self._state: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._loads: np.ndarray = np.zeros(0, dtype=np.int64)

        self.total_count = 0
        self.total_checksum = 0
        # sketch passes THIS engine computed itself (multi-tenant sharing:
        # an engine absorbing shared increments never bumps this — the
        # tenancy tests assert the shared pass ran once per relation batch)
        self.sketch_ingest_calls = 0
        # recovery-domain label: "" single-tenant; MultiQueryEngine sets it
        # so tenant-scoped host faults fire only in the victim's engine
        self.tenant = ""
        self.window_count = 0  # fingerprint of the retained window
        self.window_checksum = 0
        self.cumulative_comm = 0
        self.total_migrated = 0
        self.expired_batches = 0  # batches retired from the window so far
        self.total_retracted = 0  # results retracted from the window so far
        self.reports: list[BatchReport] = []

        self._controller: AdmissionController | None = (
            AdmissionController(config.admission, query, config.q)
            if config.admission.enabled
            else None
        )

        # reducer-loss recovery (DESIGN.md §5): host placement, heartbeat
        # detector clocked in batch indices, and the per-event reports
        self._hosts: HostTracker | None = (
            HostTracker(config.recovery) if config.recovery.enabled else None
        )
        self._detector: FailureDetector | None = (
            FailureDetector(config.recovery.deadline_batches)
            if config.recovery.enabled
            else None
        )
        self._fault_injector = None  # armed via arm_faults()
        self._pending_host_events: list = []
        self._exhausted = False
        self._slots_per_host = 1
        self.recoveries: list[RecoveryReport] = []
        self.total_replayed = 0

        # fused-ingest bookkeeping: columns the kernel must sketch per
        # relation (tracker attr order), and a loud counter so callers can
        # verify the fused path actually ran (no silent fallback exists,
        # but benchmarks assert on this to keep it that way)
        self._sketch_cols: dict[str, tuple[tuple[str, int], ...]] = {
            rel.name: tuple(
                (a, rel.index_of(a))
                for a in self.tracker.attrs
                if a in rel.attrs
            )
            for rel in query.relations
        }
        self.fused_batches = 0
        # dense route-encoding cache (fused_dynamic_routes): checked and
        # packed on the device once per relation and plan epoch
        self._dense_enc: dict[str, tuple] = {}
        # merge-join delta index (DESIGN.md §7): exact sorted-key evaluation
        # of the telescoping terms for binary single-column joins, replacing
        # the dense einsum whose cost is padded to the hottest reducer bin.
        # Bit-identical; the einsum stays the oracle (and the n-way path).
        self._delta_index: SortedDeltaIndex | None = (
            SortedDeltaIndex(self.spec)
            if config.fused_ingest and SortedDeltaIndex.eligible(self.spec)
            else None
        )

    # ---- internals ---------------------------------------------------------
    def _validate_batch(
        self, batch: dict[str, np.ndarray]
    ) -> dict[str, np.ndarray]:
        """Schema-validate one offered batch BEFORE any state mutation.

        The containment contract for multi-tenant quarantine (DESIGN.md
        §9): a poison-pill batch (missing relation, wrong arity, NaN,
        values outside the int32 routing domain) raises ``ValueError``
        here, with the engine untouched — no backlog mutated, no window
        expired, no sketch decayed — so a circuit-breaker reopen can
        safely retry the next batch on the same engine."""
        out = {}
        for r in self.query.relations:
            if r.name not in batch:
                raise ValueError(
                    f"poisoned batch: missing relation {r.name!r}"
                )
            rows = np.asarray(batch[r.name])
            if rows.dtype == object or not (
                np.issubdtype(rows.dtype, np.integer)
                or np.issubdtype(rows.dtype, np.floating)
            ):
                raise ValueError(
                    f"poisoned batch: relation {r.name!r} has non-numeric "
                    f"dtype {rows.dtype}"
                )
            if rows.ndim == 2 and rows.shape[1] != r.arity:
                raise ValueError(
                    f"poisoned batch: relation {r.name!r} rows have "
                    f"{rows.shape[1]} columns, schema arity is {r.arity}"
                )
            if rows.ndim > 2 or (rows.ndim < 2 and rows.size % r.arity):
                raise ValueError(
                    f"poisoned batch: relation {r.name!r} shape "
                    f"{rows.shape} does not pack into arity {r.arity}"
                )
            if np.issubdtype(rows.dtype, np.floating):
                if rows.size and not np.isfinite(rows).all():
                    raise ValueError(
                        f"poisoned batch: relation {r.name!r} contains "
                        "non-finite values"
                    )
            if rows.size:
                lo, hi = rows.min(), rows.max()
                if hi >= 2**31 or lo < -(2**31):
                    raise ValueError(
                        f"poisoned batch: relation {r.name!r} values "
                        f"[{lo}, {hi}] leave the int32 routing domain"
                    )
            out[r.name] = rows.reshape(-1, r.arity)
        return out

    def _threshold(self) -> float:
        t = self.config.hh_threshold
        return float(self.config.q if t is None else t)

    def _upload(self, rows: np.ndarray) -> torch.Tensor:
        """Rows as an int32 tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(rows.astype(np.int32))).to(self.device)

    def _route(self, rel, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """map_phase one relation on the device; returns flat (dest, rows)
        of valid emissions (the per-tuple replication already expanded)."""
        arity = rows.shape[1]
        if rows.shape[0] == 0:
            return np.empty(0, np.int32), np.empty((0, arity), np.int32)
        dest = map_phase(self.plan, rel, self._upload(rows)).cpu().numpy()  # [N, W]
        n, w = dest.shape
        flat_dest = dest.reshape(-1)
        flat_rows = np.broadcast_to(
            rows.astype(np.int32)[:, None, :], (n, w, arity)
        ).reshape(-1, arity)
        ok = flat_dest >= 0
        return flat_dest[ok].astype(np.int32), flat_rows[ok]

    def _dense_routes(self, rel, routes: tuple) -> DenseRoutes:
        """The dense encoding of ``routes`` at their real width, packed
        on the engine's device; cached per plan epoch."""
        cached = self._dense_enc.get(rel.name)
        if cached is not None and cached[0] == self.plan_epoch:
            return cached[1]
        enc = dense_route_encoding(
            routes, rel.arity, route_width(routes),
            max_values=max(1, self.config.max_hh_per_attr),
        )
        packed = pack_routes(enc, self.device)
        self._dense_enc[rel.name] = (self.plan_epoch, packed)
        return packed

    def _fused_pass(
        self, rel, rows: np.ndarray, with_route: bool, with_sketch: bool
    ) -> tuple[_Routed | None, dict[str, np.ndarray] | None]:
        """One fused-kernel pass over ``rows`` on the device (DESIGN.md §7).

        Returns (routed emissions under the CURRENT plan if ``with_route``,
        per-attr Count-Min table increments if ``with_sketch``)."""
        arity = rows.shape[1]
        cols = self._sketch_cols[rel.name] if with_sketch else ()
        seeds = self.tracker.seeds
        width = self.config.sketch_width
        k = self.plan.total_reducers if with_route else 1
        routes = static_route_table(self.plan, rel) if with_route else ()

        empty_routed = _Routed(
            np.empty(0, np.int32),
            np.empty((0, arity), np.int32),
            np.empty(0, np.int32),
            np.zeros(k, np.int64),
        )
        zero_deltas = {
            a: np.zeros((len(seeds), width), np.float64) for a, _ in cols
        }
        if rows.shape[0] == 0 or (not routes and not cols):
            return (empty_routed if with_route else None), (
                zero_deltas if with_sketch else None
            )

        sketch_cols = tuple(c for _, c in cols)
        if routes and self.config.fused_dynamic_routes:
            dest, rank, counts, cms = fused_ingest_dense(
                self._upload(rows), self._dense_routes(rel, routes),
                sketch_cols=sketch_cols, seeds=seeds, width=width, k_pad=k,
            )
        else:
            dest, rank, counts, cms = fused_ingest(
                self._upload(rows), routes=routes, sketch_cols=sketch_cols,
                seeds=seeds, width=width, num_reducers=k,
            )
        routed = None
        if with_route:
            dest, rank = dest.cpu().numpy(), rank.cpu().numpy()
            n, w = dest.shape
            flat_dest = dest.reshape(-1)
            flat_rank = rank.reshape(-1)
            flat_rows = np.broadcast_to(
                rows.astype(np.int32)[:, None, :], (n, w, arity)
            ).reshape(-1, arity)
            ok = flat_dest >= 0
            routed = _Routed(
                flat_dest[ok].astype(np.int32),
                flat_rows[ok],
                flat_rank[ok],
                counts.cpu().numpy().astype(np.int64),
            )
        deltas = None
        if with_sketch:
            cms_np = cms.cpu().numpy() if cms is not None else None
            deltas = {
                a: cms_np[i].astype(np.float64)
                for i, (a, _) in enumerate(cols)
            }
        return routed, deltas

    def _route_any(self, rel, rows: np.ndarray) -> _Routed:
        """Route one relation under the current plan — fused kernel or the
        baseline ``map_phase`` path, per config."""
        if self.config.fused_ingest:
            routed, _ = self._fused_pass(rel, rows, True, False)
            return routed
        dest, emitted = self._route(rel, rows)
        counts = np.bincount(
            dest, minlength=self.plan.total_reducers
        ).astype(np.int64)
        return _Routed(dest, emitted, None, counts)

    def _empty_state(
        self, arity: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        k = self.plan.total_reducers
        return (
            np.zeros((k, 1, arity), np.int32),
            np.zeros((k, 1), bool),
            np.zeros(k, np.int64),
        )

    def _scatter_into(
        self,
        state: tuple[np.ndarray, np.ndarray, np.ndarray],
        dest: np.ndarray,
        rows: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Append emissions to a binned state: slot = rank-in-group + current
        occupancy.  Grows cap (pow2) when a reducer's bin fills."""
        bins, valid, occup = state
        k = bins.shape[0]
        if dest.size == 0:
            return state
        counts = np.bincount(dest, minlength=k)
        new_occup = occup + counts
        cap = bins.shape[1]
        cap_needed = int(new_occup.max())
        if cap_needed > cap:
            new_cap = _pow2(cap_needed)
            bins = np.pad(bins, ((0, 0), (0, new_cap - cap), (0, 0)))
            valid = np.pad(valid, ((0, 0), (0, new_cap - cap)))
        else:
            bins, valid = bins.copy(), valid.copy()
        order = np.argsort(dest, kind="stable")
        ds, rs = dest[order], rows[order]
        first = np.searchsorted(ds, ds, side="left")
        rank = np.arange(ds.size) - first + occup[ds]
        bins[ds, rank] = rs
        valid[ds, rank] = True
        return bins, valid, new_occup

    def _scatter_any(
        self,
        state: tuple[np.ndarray, np.ndarray, np.ndarray],
        routed: _Routed,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Append a routed batch to a binned state.  With a fused-kernel
        pack plan the slot is ``occupancy + rank`` directly (no sort); the
        result is bit-identical to ``_scatter_into``."""
        if routed.rank is None:
            return self._scatter_into(state, routed.dest, routed.rows)
        bins, valid, occup = state
        if routed.dest.size == 0:
            return state
        new_occup = occup + routed.counts
        cap = bins.shape[1]
        cap_needed = int(new_occup.max())
        if cap_needed > cap:
            new_cap = _pow2(cap_needed)
            bins = np.pad(bins, ((0, 0), (0, new_cap - cap), (0, 0)))
            valid = np.pad(valid, ((0, 0), (0, new_cap - cap)))
        else:
            bins, valid = bins.copy(), valid.copy()
        slots = routed.rank + occup[routed.dest]
        bins[routed.dest, slots] = routed.rows
        valid[routed.dest, slots] = True
        return bins, valid, new_occup

    def _rebuild_routed_state(self) -> int:
        """Re-route every retained batch under ``self.plan`` from scratch:
        binned state, per-reducer loads, the per-batch routed log (when
        retention needs it), and the sorted delta index.  Batch-sequential
        scatters reproduce the concatenated route bit-for-bit (map_phase is
        per-row deterministic and appends preserve arrival order).  Returns
        the number of emissions routed — the migration count at replans.
        This is also where retention's deferred *compaction* lands: bins
        are rebuilt at tight capacity over the retained suffix only, so
        expiry never needs its own shuffle or re-route."""
        keep_log = self.config.retention.enabled
        self._loads = np.zeros(self.plan.total_reducers, dtype=np.int64)
        skew = self.obs.skew
        if skew is not None:  # mirror of the _loads reset: new reducer space
            skew.install(self.plan.total_reducers)
        self._routed_log = {r.name: [] for r in self.query.relations}
        if self._delta_index is not None:
            for nm in self.spec.rel_names:
                self._delta_index.clear(nm)
        for rel in self.query.relations:
            self._state[rel.name] = self._empty_state(rel.arity)
        total = 0
        for i, bid in enumerate(self._retained_ids):
            for rel in self.query.relations:
                nm = rel.name
                routed = self._route_any(rel, self._history[nm][i])
                self._state[nm] = self._scatter_any(self._state[nm], routed)
                if keep_log:
                    self._routed_log[nm].append(routed)
                if self._delta_index is not None:
                    self._delta_index.append(nm, routed.dest, routed.rows, bid)
                self._loads += routed.counts
                if skew is not None:
                    skew.record(nm, routed.counts)
                total += int(routed.dest.size)
        return total

    def _install(self, plan: SharesSkewPlan, batch: dict[str, np.ndarray]) -> int:
        """Switch to ``plan``; re-route retained history under it.
        Returns the number of migrated emissions."""
        self.plan = plan
        self.plan_epoch += 1
        self.monitor.install(plan, self.query, batch)
        with self.obs.span(
            "replan.migrate", args={"epoch": self.plan_epoch}
        ):
            migrated = self._rebuild_routed_state()
        self.total_migrated += migrated
        if self._hosts is not None:
            self._hosts.assign(plan.total_reducers)
            self._slots_per_host = max(
                1,
                -(-plan.total_reducers // max(1, len(self._hosts.alive))),
            )
        return migrated

    # ---- retention (DESIGN.md §8) ------------------------------------------
    def _retract_sorted(
        self, bid: int, expired: dict[str, _Routed]
    ) -> tuple[int, int]:
        """Retraction terms via ``SortedDeltaIndex``.  Term i of
        join(A) − join(S) is A_1..A_{i-1} ⋈ E_i ⋈ S_{i+1}..S_n, so probing
        runs in *reverse* relation order: E_i probes the other relation's
        index after relations > i already expired (mirror of insertion)."""
        idx = self._delta_index
        names = self.spec.rel_names
        d_count, d_checksum = 0, 0
        for i in reversed(range(len(names))):
            nm = names[i]
            e = expired[nm]
            idx.expire(nm, bid)  # E_i leaves its own index first (j == i)
            if e.dest.size:
                cnt, chk = idx.probe(names[1 - i], nm, e.dest, e.rows)
                d_count += cnt
                d_checksum = (d_checksum + chk) & _MASK32
        return d_count, d_checksum

    def _device_bins(
        self, bins: np.ndarray, valid: np.ndarray
    ) -> tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.from_numpy(np.ascontiguousarray(bins)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(valid)).to(self.device),
        )

    def _join_terms(self, variants, skip) -> tuple[int, int]:
        """Sum the telescoping terms on the device.  ``variants[name]`` is
        a triple of (bins, valid) device tensors: term i joins the first of
        relations j < i, the second of relation i and the third of
        relations j > i.  Terms whose relation is in ``skip`` are empty and
        not evaluated."""
        names = [r.name for r in self.query.relations]
        d_count, d_checksum = 0, 0
        for i, nm_i in enumerate(names):
            if nm_i in skip:
                continue
            bins, valids = {}, {}
            for j, nm_j in enumerate(names):
                key = 0 if j < i else (1 if j == i else 2)
                bins[nm_j], valids[nm_j] = variants[nm_j][key]
            cnt, chk = local_join_count_checksum(self.spec, bins, valids)
            d_count += int(cnt)
            d_checksum = (d_checksum + int(chk)) & _MASK32
        return d_count, d_checksum

    def _retract_einsum(
        self,
        expired: dict[str, _Routed],
        survivors: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]],
    ) -> tuple[int, int]:
        """Retraction terms via the dense per-reducer join: j<i → current
        state (A, expiring batch still resident), j==i → the expiring
        emissions E, j>i → survivors S.  Exact mirror of the insertion
        telescoping."""
        k = self.plan.total_reducers
        variants = {}
        for rel in self.query.relations:
            nm = rel.name
            e = expired[nm]
            ecap = _pow2(max(int(e.counts.max()) if e.dest.size else 0, 1))
            ebins, evalid = _group_np(e.dest, e.rows, k, ecap)
            abins, avalid, _ = self._state[nm]
            sbins, svalid, _ = survivors[nm]
            variants[nm] = (
                self._device_bins(abins, avalid),
                self._device_bins(ebins, evalid),
                self._device_bins(sbins, svalid),
            )
        skip = {nm for nm, e in expired.items() if e.dest.size == 0}
        return self._join_terms(variants, skip)

    def _retract_oldest(self) -> int:
        """Expire the oldest retained batch: subtract its window-join
        contribution (exact, mod 2^32) and shift its tuples out of carried
        state.  Pure host-side compute on already-routed state — expiry
        never re-shuffles (capacity compaction rides the replan rebuild).
        Returns the number of retracted join results."""
        bid = self._retained_ids.pop(0)
        self._batch_ts.pop(0)
        expired = {nm: self._routed_log[nm].pop(0) for nm in self._routed_log}
        for rel in self.query.relations:
            self._history[rel.name].pop(0)
        survivors = {
            nm: remove_prefix(self._state[nm], expired[nm].counts)
            for nm in self._state
        }
        if self._delta_index is not None:
            cnt, chk = self._retract_sorted(bid, expired)
        else:
            cnt, chk = self._retract_einsum(expired, survivors)
        self._state.update(survivors)
        self.window_count -= cnt
        self.window_checksum = (self.window_checksum - chk) & _MASK32
        self.expired_batches += 1
        self.total_retracted += cnt
        return cnt

    def _expire_due(self, now: float) -> tuple[int, int]:
        """Retire every retained batch outside the window/TTL before the
        next ingest.  Returns (batches expired, results retracted)."""
        policy = self.config.retention
        if not policy.enabled or not self._retained_ids:
            return 0, 0
        drop = policy.expired_prefix(
            self._retained_ids, self._batch_ts, len(self.reports), now
        )
        retracted = 0
        for _ in range(drop):
            retracted += self._retract_oldest()
        if drop:
            self._log(
                f"[stream] expired {drop} batch(es) from the window; "
                f"retracted {retracted} results"
            )
        return drop, retracted

    # ---- admission (DESIGN.md §8) ------------------------------------------
    def _concentration(self) -> float:
        """Predicted worst per-reducer load ÷ q for the live skew profile —
        the admission budget's skew-tightening factor."""
        from .drift import predicted_loads

        if self.plan is None:
            return 1.0
        snapshot = self.tracker.snapshot(
            self._threshold(), self.config.max_hh_per_attr
        )
        loads = predicted_loads(self.plan, snapshot)
        worst = max((load for _, _, load in loads), default=0.0)
        return max(1.0, worst / max(self.config.q, 1e-9))

    # ---- reducer-loss recovery (DESIGN.md §5) ------------------------------
    def arm_faults(self, injector) -> None:
        """Attach a ``testing.faults.FaultInjector`` whose host faults
        (``host_loss`` / ``partition``) fire at absolute batch indices at
        the ingest boundary.  Indices are absolute (``len(reports)``), so a
        restored engine resumes past already-fired faults — they never
        re-fire across a checkpoint boundary."""
        self._fault_injector = injector

    def _last_batch(self) -> dict[str, np.ndarray]:
        """Most recent retained batch (drift-monitor baseline for a repair
        install); empty arrays when nothing is retained."""
        return {
            r.name: (
                self._history[r.name][-1]
                if self._history[r.name]
                else np.zeros((0, r.arity), dtype=np.int64)
            )
            for r in self.query.relations
        }

    def _lineage(self, rel, i: int) -> _Routed:
        """Batch ``i``'s routed emissions for one relation: the retained
        routed log when retention keeps it (true lineage), else a
        deterministic re-route of the retained raw batch on the device —
        ``map_phase`` is per-row deterministic, so both reproduce the
        original emission order exactly."""
        if self.config.retention.enabled:
            return self._routed_log[rel.name][i]
        return self._route_any(rel, self._history[rel.name][i])

    def _state_join_fingerprint(self) -> tuple[int, int]:
        """(count, checksum) of the join evaluated over the carried binned
        state on the device — the oracle the window fingerprint must match."""
        bins, valids = {}, {}
        for nm, (b, v, _) in self._state.items():
            bins[nm], valids[nm] = self._device_bins(b, v)
        cnt, chk = local_join_count_checksum(self.spec, bins, valids)
        return int(cnt), int(chk) & _MASK32

    def _resolve_host_events(self, lost_hosts, recovered: bool) -> None:
        for ev in self._pending_host_events:
            if not ev.resolved and (
                ev.spec.host_id in lost_hosts or not recovered
            ):
                FaultInjector.mark_host_event(ev, recovered)

    def _exhaust(self, lost_hosts, msg: str) -> None:
        """Loss beyond the survivable grid: flag the engine dead, resolve
        the injector events as explicitly reported, and raise."""
        self._exhausted = True
        self._resolve_host_events(lost_hosts, recovered=False)
        raise RecoveryExhaustedError(msg)

    def _replay_lost(self, lost_ids: np.ndarray) -> int:
        """Lineage replay (DESIGN.md §5 stage 3): zero the lost reducers'
        bins, then re-scatter ONLY their emissions from each retained
        batch, in batch order — reproducing the dead bins bit-for-bit
        (appends land at occupancy offsets, so a batch's emissions refill
        as the same prefix they originally occupied; a fused pack plan's
        in-destination ranks select every emission of a lost destination,
        so they still start at 0).  Returns the number of replayed
        emissions."""
        for nm in self._state:
            self._state[nm] = zero_reducers(self._state[nm], lost_ids)
        if self._delta_index is not None:
            for nm in self.spec.rel_names:
                self._delta_index.drop_reducers(nm, lost_ids)
        replayed = 0
        for i, rbid in enumerate(self._retained_ids):
            for rel in self.query.relations:
                nm = rel.name
                routed = self._lineage(rel, i)
                mask = select_reducers(routed.dest, lost_ids)
                if not mask.any():
                    continue
                sub = _Routed(
                    routed.dest[mask],
                    routed.rows[mask],
                    None if routed.rank is None else routed.rank[mask],
                    np.bincount(
                        routed.dest[mask], minlength=self.plan.total_reducers
                    ).astype(np.int64),
                )
                self._state[nm] = self._scatter_any(self._state[nm], sub)
                if self._delta_index is not None:
                    self._delta_index.append(nm, sub.dest, sub.rows, rbid)
                replayed += int(sub.dest.size)
        return replayed

    def _recover(self, lost_hosts: list[int], bid: int) -> RecoveryReport:
        """Detection has declared ``lost_hosts`` dead: repair placement (or
        the plan), reconstruct the lost reducers' carried state, verify
        the window fingerprint, and report.  Raises
        ``RecoveryExhaustedError`` when the survivors cannot host a
        correct plan — explicit, never a silent wrong answer."""
        policy = self.config.recovery
        hosts = self._hosts
        self.obs.instant(
            "recovery.detect",
            cat="recovery",
            args={"hosts": sorted(lost_hosts), "batch": bid},
        )
        lost_ids = hosts.reducers_on(lost_hosts)
        hosts.declare_lost(lost_hosts)
        for h in lost_hosts:
            self._detector.deregister(h)
        survivors = len(hosts.alive)
        if survivors < policy.min_hosts:
            self._exhaust(
                lost_hosts,
                f"recovery exhausted at batch {bid}: {survivors} surviving "
                f"host(s) < min_hosts={policy.min_hosts} "
                f"(lost {sorted(lost_hosts)})",
            )
        reducers_before = self.plan.total_reducers if self.plan else 0
        lost_share = lost_occupancy(self._state, lost_ids)
        degrade = (
            self.plan is not None
            and survivors / hosts.provisioned < policy.degrade_below
        )
        replayed = migrated = 0
        if self.plan is None or lost_ids.size == 0:
            mode = "replay"  # nothing carried yet; placement repair only
            hosts.reassign(lost_ids)
        elif not degrade:
            mode = "replay"
            hosts.reassign(lost_ids)
            with self.obs.span(
                "recovery.replay",
                cat="recovery",
                args={"lost_reducers": int(lost_ids.size)},
            ):
                replayed = self._replay_lost(lost_ids)
        else:
            mode = "degrade"
            mesh = plan_mesh_shape(
                survivors, 1, chips_per_pod=policy.hosts_per_pod
            )
            k_target = mesh.chips_used * self._slots_per_host
            try:
                repaired = repair_plan(self.plan, k_target)
            except ValueError as e:
                self._exhaust(
                    lost_hosts, f"recovery exhausted at batch {bid}: {e}"
                )
            # full rebuild under the repaired plan reconstructs every
            # reducer's state (lost bins included) and re-places reducers
            # over the survivors; admission tightens to surviving capacity
            with self.obs.span(
                "recovery.repair",
                cat="recovery",
                args={"k_target": k_target, "survivors": survivors},
            ):
                migrated = self._install(repaired, self._last_batch())
            if self._controller is not None:
                self._controller.set_capacity(survivors / hosts.provisioned)
        verified = True
        if policy.verify and self.plan is not None:
            with self.obs.span("recovery.verify", cat="recovery"):
                cnt, chk = self._state_join_fingerprint()
            verified = (
                cnt == self.window_count and chk == self.window_checksum
            )
            if not verified:
                self._exhausted = True
                self._resolve_host_events(lost_hosts, recovered=False)
                raise RecoveryExhaustedError(
                    f"recovered state fails fingerprint verification at "
                    f"batch {bid}: joined ({cnt}, {chk:#010x}) != window "
                    f"({self.window_count}, {self.window_checksum:#010x})"
                )
        report = RecoveryReport(
            batch=bid,
            lost_hosts=tuple(sorted(lost_hosts)),
            lost_reducers=int(lost_ids.size),
            mode=mode,
            survivors=survivors,
            batches_replayed=len(self._retained_ids),
            replayed_tuples=replayed,
            lost_share_tuples=lost_share,
            migrated_tuples=migrated,
            reducers_before=reducers_before,
            reducers_after=self.plan.total_reducers if self.plan else 0,
            tenant=self.tenant,
            verified=verified,
        )
        self.recoveries.append(report)
        self.total_replayed += replayed
        record_recovery(self.obs, report)
        self._resolve_host_events(lost_hosts, recovered=True)
        self._log(
            f"[stream] recovered from loss of host(s) {sorted(lost_hosts)} "
            f"at batch {bid}: mode={mode}, {lost_ids.size} reducer(s), "
            f"replayed {replayed}/{lost_share} lineage tuples, "
            f"migrated {migrated}, survivors {survivors}/{hosts.provisioned}"
        )
        return report

    def _host_boundary(self, bid: int) -> None:
        """The per-batch recovery boundary: heal due partitions, fire
        scheduled host faults, heartbeat the live hosts into the detector
        (clocked in batch indices), and recover from any host the
        deadline declares lost."""
        hosts = self._hosts
        healed = hosts.heal_due(bid)
        if healed:
            self._log(
                f"[stream] partition healed at batch {bid}: host(s) "
                f"{healed} rejoin as empty spares"
            )
        if self._fault_injector is not None:
            for ev in self._fault_injector.fire_host_faults(bid, self.tenant):
                s = ev.spec
                heal = None if s.kind == "host_loss" else bid + s.heal_after
                hosts.silence(s.host_id, heal)
                self._pending_host_events.append(ev)
        members = set(self._detector.members)
        for h in hosts.alive:
            if h not in members:  # join-time registration: assume a beat
                self._detector.heartbeat(h, bid - 1)  # one batch ago
        for h in hosts.beating():
            self._detector.heartbeat(h, bid)
        lost = [h for h in self._detector.overdue(bid) if h in hosts.alive]
        if lost:
            self._recover(lost, bid)

    def fail_hosts(self, hosts_to_kill) -> RecoveryReport | None:
        """Kill hosts outright, outside the injector schedule (the demo /
        operational path: ``examples/streaming_join_torch.py
        --kill-reducer``).  Runs the same detect→recover boundary
        immediately and returns the resulting report (None if the kill
        removed no live host)."""
        if self._hosts is None:
            raise RuntimeError(
                "recovery is disabled: set StreamConfig.recovery = "
                "RecoveryPolicy(n_hosts=...)"
            )
        bid = len(self.reports)
        deadline = self.config.recovery.deadline_batches
        for h in hosts_to_kill:
            self._hosts.silence(int(h), None)
            if int(h) in self._detector.members:
                # an explicit kill is not a silent failure: rewind the
                # heartbeat past the deadline so detection fires NOW even
                # if the host beat at this same boundary already
                self._detector.heartbeat(int(h), bid - deadline)
        before = len(self.recoveries)
        self._host_boundary(bid)
        return self.recoveries[-1] if len(self.recoveries) > before else None

    # ---- delta join --------------------------------------------------------
    def _delta_join_sorted(
        self, new_routed: dict[str, _Routed], batch_id: int
    ) -> tuple[int, int]:
        """The telescoping terms via ``SortedDeltaIndex`` (binary joins on
        one shared column, fused path).  Evaluating term i against the
        index *after* relations < i appended their delta reproduces the
        all/new/old variant structure of the einsum path exactly; binned
        state is still maintained so replays and tests see one layout."""
        idx = self._delta_index
        names = self.spec.rel_names
        d_count, d_checksum = 0, 0
        for i, nm in enumerate(names):
            routed = new_routed[nm]
            if routed.dest.size:
                cnt, chk = idx.probe(names[1 - i], nm, routed.dest, routed.rows)
                d_count += cnt
                d_checksum = (d_checksum + chk) & _MASK32
            idx.append(nm, routed.dest, routed.rows, batch_id)
            self._state[nm] = self._scatter_any(self._state[nm], routed)
        return d_count, d_checksum

    def _delta_join(
        self, new_routed: dict[str, _Routed], batch_id: int
    ) -> tuple[int, int]:
        """Telescoping incremental join of the new emissions against carried
        state, then fold the batch into the state.  Returns
        (delta_count, delta_checksum)."""
        if self._delta_index is not None:
            return self._delta_join_sorted(new_routed, batch_id)
        k = self.plan.total_reducers
        variants = {}
        merged: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for rel in self.query.relations:
            nm = rel.name
            routed = new_routed[nm]
            nd, nrows = routed.dest, routed.rows
            ncap = _pow2(max(int(routed.counts.max()) if nd.size else 0, 1))
            if routed.rank is None:
                nbins, nvalid = _group_np(nd, nrows, k, ncap)
            else:  # fused pack plan: precomputed-index scatter, no sort
                nbins = np.zeros((k, ncap, nrows.shape[1]), dtype=np.int32)
                nvalid = np.zeros((k, ncap), dtype=bool)
                nbins[nd, routed.rank] = nrows
                nvalid[nd, routed.rank] = True
            obins, ovalid, _ = self._state[nm]
            merged[nm] = self._scatter_any(self._state[nm], routed)
            variants[nm] = (
                self._device_bins(merged[nm][0], merged[nm][1]),
                self._device_bins(nbins, nvalid),
                self._device_bins(obins, ovalid),
            )
        skip = {nm for nm, r in new_routed.items() if r.dest.size == 0}
        d_count, d_checksum = self._join_terms(variants, skip)
        self._state.update(merged)
        return d_count, d_checksum

    # ---- public API --------------------------------------------------------
    def ingest(
        self,
        batch: dict[str, np.ndarray],
        *,
        shared_deltas: dict[tuple[str, str], np.ndarray] | None = None,
    ) -> BatchReport:
        """Process one micro-batch; returns its telemetry.

        ``shared_deltas`` (multi-tenant mode, DESIGN.md §9): Count-Min
        table increments precomputed ONCE over this exact offered batch by
        a ``MultiQueryEngine`` shared ingest pass, keyed ``(attr,
        rel_name)``.  They are absorbed instead of running this engine's
        own sketch pass — bit-identical (integer counts are exact in
        float64) — but ONLY when the admitted rows equal the offered rows
        (empty backlog, nothing deferred or shed); a throttled tenant's
        sketch must see its own admitted subset, so it falls back to a
        private pass.

        With ``config.obs`` enabled (DESIGN.md §10) the batch runs under a
        root ``ingest`` span with the lifecycle phases nested inside, the
        per-batch metrics land in the shared registry, and the returned
        report's ``obs`` field carries the post-batch metrics + skew
        snapshots (compare-excluded; the deterministic fields still take
        part in the baseline-vs-fused parity assertions).
        """
        obs = self.obs
        obs.tracer.set_batch(len(self.reports))
        t0 = time.perf_counter()
        with obs.span("ingest", args={"tenant": self.tenant} if obs.tracer.enabled else None):
            report = self._ingest_inner(batch, shared_deltas)
        if obs.metrics.enabled or obs.skew is not None:
            if obs.metrics.enabled:
                self._record_batch_metrics(report, time.perf_counter() - t0)
            payload: dict = {}
            if obs.metrics.enabled:
                payload["metrics"] = obs.metrics.snapshot()
            if obs.skew is not None:
                payload["skew"] = obs.skew.snapshot().as_dict()
            report = dataclasses.replace(report, obs=payload)
            self.reports[-1] = report
        return report

    def _record_batch_metrics(self, report: BatchReport, seconds: float) -> None:
        """Fold one finished batch into the metrics registry (tenant label
        injected by the facade when this engine is a tenant view)."""
        obs = self.obs
        obs.counter("stream_batches_total").inc()
        obs.counter("stream_results_total").inc(report.delta_count)
        for rel in self.query.relations:
            n = report.comm_tuples.get(rel.name, 0)
            obs.counter("stream_comm_tuples_total", rel=rel.name).inc(n)
            # int32 rows: every shipped cell is 4 bytes (obs.skewscope)
            obs.counter("stream_comm_bytes_total", rel=rel.name).inc(
                n * rel.arity * 4
            )
        for nm, n in report.shed.items():
            if n:
                obs.counter("stream_shed_rows_total", rel=nm).inc(n)
        for nm, n in report.deferred.items():
            obs.gauge("stream_deferred_rows", rel=nm).set(n)
        if report.replanned:
            obs.counter(
                "stream_replan_total",
                trigger=report.drift_trigger or "initial",
            ).inc()
        if report.migrated_tuples:
            obs.counter("stream_migrated_tuples_total").inc(report.migrated_tuples)
        if report.expired_batches:
            obs.counter("stream_expired_batches_total").inc(report.expired_batches)
        if report.retracted_count:
            obs.counter("stream_retracted_results_total").inc(report.retracted_count)
        obs.gauge("stream_window_batches").set(len(self._retained_ids))
        obs.gauge("stream_carried_tuples").set(report.carried_tuples)
        obs.gauge("stream_max_load").set(report.max_load)
        obs.gauge("stream_plan_epoch").set(report.plan_epoch)
        obs.histogram("stream_batch_seconds").observe(seconds)

    def _ingest_inner(
        self,
        batch: dict[str, np.ndarray],
        shared_deltas: dict[tuple[str, str], np.ndarray] | None,
    ) -> BatchReport:
        if self._exhausted:
            raise RecoveryExhaustedError(
                "engine lost more hosts than the survivable grid; carried "
                "state is unrecoverable and ingest refuses to produce "
                "answers from it"
            )
        # validation FIRST: a poison batch must raise before any state
        # mutation so the engine stays resumable (DESIGN.md §9)
        offered = self._validate_batch(batch)
        now = self._clock()

        # 0. recovery boundary: heal partitions, fire scheduled host
        #    faults, detect and recover losses BEFORE the batch joins
        if self._hosts is not None:
            with self.obs.span("recovery.boundary", cat="recovery"):
                self._host_boundary(len(self.reports))

        # 1. admission: backlog + batch against the live budget
        if self._controller is not None:
            backlog_empty = all(
                arr.shape[0] == 0 for arr in self._controller.backlog.values()
            )
            with self.obs.span("admission"):
                admitted, decision = self._controller.admit(
                    offered, self.plan, self._concentration()
                )
            deferred, shed = decision.deferred, decision.shed
            pristine = (
                backlog_empty
                and decision.total_deferred == 0
                and decision.total_shed == 0
            )
        else:
            admitted = offered
            deferred = {nm: 0 for nm in offered}
            shed = {nm: 0 for nm in offered}
            pristine = True
        batch = {
            nm: np.ascontiguousarray(rows) for nm, rows in admitted.items()
        }
        use_shared = (
            shared_deltas is not None
            and pristine
            and all(
                (a, rel.name) in shared_deltas
                for rel in self.query.relations
                for a in self.tracker.attrs
                if a in rel.attrs
            )
        )

        # 2. retention: retire batches that left the window BEFORE this one
        #    joins, so new tuples only meet retained partners
        with self.obs.span("retention.expire"):
            expired_n, retracted = self._expire_due(now)

        # speculative routing under the plan that was live when the batch
        # arrived; discarded (and redone) only if this batch triggers a
        # replan, so the common case is ONE fused pass per relation
        spec_routes: dict[str, _Routed] = {}
        if use_shared:
            # absorb the MultiQueryEngine's shared CMS increments (computed
            # once over this exact batch) instead of a private sketch pass
            picked = {
                (a, rel.name): shared_deltas[(a, rel.name)]
                for rel in self.query.relations
                for a in self.tracker.attrs
                if a in rel.attrs
            }
            if self.config.fused_ingest:
                has_plan = self.plan is not None
                with self.obs.span("route.fused"):
                    for rel in self.query.relations:
                        routed, _ = self._fused_pass(
                            rel, batch[rel.name], with_route=has_plan,
                            with_sketch=False,
                        )
                        if routed is not None:
                            spec_routes[rel.name] = routed
                self.fused_batches += 1
            with self.obs.span("sketch.update", args={"shared": True}):
                self.tracker.observe_absorbed(batch, picked)
        elif self.config.fused_ingest:
            deltas: dict[tuple[str, str], np.ndarray] = {}
            has_plan = self.plan is not None
            # route + sketch increment are ONE fused pass per relation
            # (DESIGN.md §7); the span covers both halves of the taxonomy
            with self.obs.span("route.fused"):
                for rel in self.query.relations:
                    routed, d = self._fused_pass(
                        rel, batch[rel.name], with_route=has_plan, with_sketch=True
                    )
                    if d is not None:
                        for a, tbl in d.items():
                            deltas[(a, rel.name)] = tbl
                    if routed is not None:
                        spec_routes[rel.name] = routed
            with self.obs.span("sketch.update"):
                self.tracker.observe_absorbed(batch, deltas)
            self.fused_batches += 1
            self.sketch_ingest_calls += 1
        else:
            with self.obs.span("sketch.update"):
                self.tracker.observe(batch)
            self.sketch_ingest_calls += 1
        snapshot = self.tracker.snapshot(
            self._threshold(), self.config.max_hh_per_attr
        )
        hh = {a: s.values for a, s in snapshot.items()}

        replanned, reason, migrated = False, "", 0
        trigger, observed, threshold = "", 0.0, 0.0
        if self.plan is None:
            trigger = "initial"
            with self.obs.span("replan", args={"trigger": trigger}):
                with self.obs.span("replan.solve"):
                    plan = plan_with_hh(
                        self.query, batch, self.config.q, hh,
                        self.config.max_hh_per_attr,
                    )
                migrated = self._install(plan, batch)
            replanned, reason = True, "initial plan"
        else:
            pinned_rates = {
                (a, int(v)): float(self.tracker.rate_of(a, np.array([v]))[0])
                for a, vals in self.plan.hh_values.items()
                for v in np.asarray(vals).tolist()
            }
            with self.obs.span("drift.check"):
                decision: DriftDecision = self.monitor.check(
                    self.plan, self.query, batch, snapshot, pinned_rates
                )
            if decision.trigger:
                # recorded even when cooldown suppresses the replan, so the
                # trace tells "drifted but cooling down" from "no drift"
                self.obs.instant(
                    "drift.trigger",
                    args={
                        "trigger": decision.trigger,
                        "observed": decision.observed,
                        "threshold": decision.threshold,
                        "replan": decision.replan,
                    },
                )
            if decision.replan:
                trigger = decision.trigger
                observed, threshold = decision.observed, decision.threshold
                with self.obs.span("replan", args={"trigger": trigger}):
                    with self.obs.span("replan.solve"):
                        plan = plan_with_hh(
                            self.query, batch, self.config.q, hh,
                            self.config.max_hh_per_attr,
                        )
                    migrated = self._install(plan, batch)
                replanned, reason = True, decision.reason
                self._log(
                    f"[stream] replan epoch={self.plan_epoch} ({reason}); "
                    f"migrated {migrated} emissions"
                )
        if replanned:
            spec_routes = {}  # routed under the stale plan; redo below

        # route the new batch under the (possibly fresh) plan
        new_routed, comm = {}, {}
        skew = self.obs.skew
        with self.obs.span("route"):
            for rel in self.query.relations:
                routed = spec_routes.get(rel.name)
                if routed is None:
                    routed = self._route_any(rel, batch[rel.name])
                new_routed[rel.name] = routed
                comm[rel.name] = int(routed.dest.size)
                self._loads += routed.counts
                if skew is not None:
                    skew.record(rel.name, routed.counts)
        if skew is not None:
            skew.record_hh(*hh_hit_counts(self.query, batch, self.plan.hh_values))

        bid = len(self.reports)
        with self.obs.span("join.delta"):
            d_count, d_checksum = self._delta_join(new_routed, bid)
        self.total_count += d_count
        self.total_checksum = (self.total_checksum + d_checksum) & _MASK32
        self.window_count += d_count
        self.window_checksum = (self.window_checksum + d_checksum) & _MASK32
        self.cumulative_comm += sum(comm.values())

        # raw rows are kept only for replan migration; the binned reducer
        # state was already folded by _delta_join.  The routed log feeds
        # retraction and is kept only under retention.
        self._retained_ids.append(bid)
        self._batch_ts.append(now)
        for rel in self.query.relations:
            self._history[rel.name].append(batch[rel.name])
            if self.config.retention.enabled:
                self._routed_log[rel.name].append(new_routed[rel.name])

        carried, max_carried = carried_tuples(self._state)
        report = BatchReport(
            batch=bid,
            plan_epoch=self.plan_epoch,
            replanned=replanned,
            drift_reason=reason,
            delta_count=d_count,
            total_count=self.total_count,
            total_checksum=self.total_checksum,
            comm_tuples=comm,
            cumulative_comm=self.cumulative_comm,
            migrated_tuples=migrated,
            max_load=int(self._loads.max()) if self._loads.size else 0,
            hh_values={
                a: np.asarray(v).tolist() for a, v in self.plan.hh_values.items()
            },
            deferred=deferred,
            shed=shed,
            expired_batches=expired_n,
            retracted_count=retracted,
            window_count=self.window_count,
            window_checksum=self.window_checksum,
            carried_tuples=carried,
            max_carried=max_carried,
            drift_trigger=trigger,
            drift_observed=observed,
            drift_threshold=threshold,
        )
        self.reports.append(report)
        self._log(
            f"[stream] batch {report.batch}: +{d_count} results "
            f"(total {self.total_count}), comm {report.total_comm}, "
            f"hh {report.hh_values or '{}'}"
        )
        return report

    def history_data(self) -> dict[str, np.ndarray]:
        """The concatenation of every *retained* batch — the full stream
        when retention is off, the window suffix when it is on."""
        return {
            r.name: (
                np.concatenate(self._history[r.name], axis=0)
                if self._history[r.name]
                else np.zeros((0, r.arity), dtype=np.int64)
            )
            for r in self.query.relations
        }

    def recompute_distributed(self, window: bool = False, **kwargs):
        """Replay the retained input through the distributed shuffle under
        the current plan, on the engine's device (correctness cross-check
        for carried state); ``kwargs`` go to ``run_distributed`` (``group``,
        ``cap_factor``, ``route_cap_factor``).

        With retention off this reproduces the cumulative fingerprint.
        With retention on and history expired, the full-stream input no
        longer exists — the replay covers the retained window only, whose
        reference is (``window_count``, ``window_checksum``); pass
        ``window=True`` to acknowledge that, otherwise this refuses rather
        than silently comparing a truncated replay against the full-stream
        fingerprint."""
        if self.plan is None:
            raise RuntimeError("no batches ingested yet")
        if self.expired_batches and not window:
            raise RuntimeError(
                f"retention has expired {self.expired_batches} batch(es): "
                "the retained window cannot reproduce the full-stream "
                "fingerprint (total_count/total_checksum).  Call "
                "recompute_distributed(window=True) to cross-check the "
                "retained suffix against (window_count, window_checksum)."
            )
        return run_distributed(self.query, self.history_data(), self.plan,
                               device=self.device, **kwargs)

    @property
    def replan_count(self) -> int:
        """Drift-triggered replans (the initial plan does not count)."""
        return sum(1 for r in self.reports if r.replanned) - (1 if self.reports else 0)

    @property
    def total_deferred(self) -> int:
        return self._controller.total_deferred if self._controller else 0

    @property
    def total_shed(self) -> int:
        return self._controller.total_shed if self._controller else 0

    def skew_report(self):
        """The SkewScope snapshot with the Count-Min error audit folded in
        (DESIGN.md §10).  The audit walks the retained window computing
        decay-weighted exact counts, so it runs on demand here — not per
        ingest — keeping the per-batch obs cost flat."""
        skew = self.obs.skew
        if skew is None:
            raise RuntimeError(
                "skewscope is disabled: set StreamConfig.obs = "
                "ObsPolicy(skewscope=True)"
            )
        skew.record_cms_error(
            cms_window_error(
                self.tracker, self.query, self._history, self._retained_ids
            )
        )
        return skew.snapshot()

    # ---- checkpoint / restore (DESIGN.md §8) -------------------------------
    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        """Serialize the full engine state through ``train.checkpoint``
        (atomic step dir + LATEST pointer; step = batches ingested), in the
        JAX package's tree and keys.  Everything needed for a bit-identical
        resume goes in: sketches, drift-monitor baselines, retained history
        + window clock (stored as ages so TTL survives a clock rebase),
        admission backlog, incumbent plan and reports (pickled blobs), the
        recovery state, and the cumulative counters."""
        now = self._clock()
        tree: dict = {
            "scalars": np.array(
                [
                    self.total_count,
                    self.total_checksum,
                    self.window_count,
                    self.window_checksum,
                    self.cumulative_comm,
                    self.total_migrated,
                    self.expired_batches,
                    self.total_retracted,
                    self.plan_epoch,
                    self.fused_batches,
                ],
                dtype=np.int64,
            ),
            "loads": self._loads.astype(np.int64),
            "retained_ids": np.array(self._retained_ids, dtype=np.int64),
            "batch_ages": np.array(
                [now - ts for ts in self._batch_ts], dtype=np.float64
            ),
            "tracker": self.tracker.state_dict(),
            "monitor": self.monitor.state_dict(),
            "history": {
                nm: {f"{i:06d}": np.asarray(arr) for i, arr in enumerate(lst)}
                for nm, lst in self._history.items()
            },
            "blob": _pickle_blob((self.plan, self.reports)),
        }
        if self._controller is not None:
            tree["admission"] = self._controller.state_dict()
        if self._hosts is not None:
            tree["hosts"] = self._hosts.state_dict()
            tree["recovery_scalars"] = np.array(
                [int(self._exhausted), self._slots_per_host, self.total_replayed],
                dtype=np.int64,
            )
            tree["recovery_blob"] = _pickle_blob(self.recoveries)
        with self.obs.span("checkpoint.save"):
            path = checkpoint.save_checkpoint(
                directory,
                step=len(self.reports),
                tree=tree,
                keep=keep,
                metadata={
                    "kind": "stream_engine",
                    "format": CHECKPOINT_FORMAT,
                    "batches": len(self.reports),
                    "retained": len(self._retained_ids),
                },
            )
        if self.obs.metrics.enabled:
            nbytes = sum(
                os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(path)
                for f in fs
            )
            self.obs.counter("stream_checkpoints_total").inc()
            self.obs.counter("stream_checkpoint_bytes_total").inc(nbytes)
        return path

    @classmethod
    def restore(
        cls,
        directory: str,
        query: JoinQuery,
        config: StreamConfig,
        log_fn: Callable[[str], None] | None = None,
        clock: Callable[[], float] | None = None,
        step: int | None = None,
        device: str | torch.device = "cuda",
        obs: Observability | None = None,
    ) -> "StreamingJoinEngine":
        """Rebuild an engine mid-stream from a checkpoint, this package's or
        the JAX package's.  ``query`` and ``config`` must match the saving
        engine (sketch shapes/seeds are config-derived).  Carried reducer
        state is reconstructed on ``device`` by re-routing the retained
        history under the restored plan — the same deterministic rebuild a
        replan migration performs — so subsequent batches produce
        bit-identical reports to an uninterrupted run."""
        manifest = checkpoint.load_manifest(directory, step)
        meta = manifest.get("metadata", {})
        if meta.get("kind") != "stream_engine":
            raise ValueError(f"not a stream engine checkpoint: {directory}")
        if meta.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(
                f"checkpoint format {meta.get('format')} != "
                f"supported {CHECKPOINT_FORMAT}"
            )
        _, flat = checkpoint.load_checkpoint(directory, step)

        eng = cls(query, config, log_fn=log_fn, clock=clock, device=device, obs=obs)
        plan, reports = _unpickle(flat["blob"])
        eng.plan = plan
        eng.reports = list(reports)
        scalars = np.asarray(flat["scalars"]).tolist()
        (
            eng.total_count,
            eng.total_checksum,
            eng.window_count,
            eng.window_checksum,
            eng.cumulative_comm,
            eng.total_migrated,
            eng.expired_batches,
            eng.total_retracted,
            eng.plan_epoch,
            eng.fused_batches,
        ) = (int(s) for s in scalars)
        eng.tracker.load_state_dict(
            {
                k[len("tracker/") :]: v
                for k, v in flat.items()
                if k.startswith("tracker/")
            }
        )
        eng.monitor.load_state_dict({"scalars": flat["monitor/scalars"]})
        eng._retained_ids = [int(i) for i in flat["retained_ids"]]
        now = eng._clock()
        eng._batch_ts = [now - float(a) for a in flat["batch_ages"]]
        for rel in query.relations:
            prefix = f"history/{rel.name}/"
            keys = sorted(k for k in flat if k.startswith(prefix))
            eng._history[rel.name] = [
                np.asarray(flat[k]).reshape(-1, rel.arity) for k in keys
            ]
            if len(eng._history[rel.name]) != len(eng._retained_ids):
                raise ValueError("checkpoint history/window length mismatch")
        if eng._controller is not None:
            eng._controller.load_state_dict(
                {
                    k[len("admission/") :]: v
                    for k, v in flat.items()
                    if k.startswith("admission/")
                }
            )
        if eng._hosts is not None and "hosts/alive" in flat:
            eng._hosts.load_state_dict(
                {
                    k[len("hosts/") :]: v
                    for k, v in flat.items()
                    if k.startswith("hosts/")
                }
            )
            rs = np.asarray(flat["recovery_scalars"]).tolist()
            eng._exhausted = bool(rs[0])
            eng._slots_per_host = int(rs[1])
            eng.total_replayed = int(rs[2])
            eng.recoveries = _unpickle(flat["recovery_blob"])
        if eng.plan is not None:
            eng._rebuild_routed_state()
            if eng._hosts is not None and (
                eng._hosts.host_of.size != eng.plan.total_reducers
            ):  # pre-recovery checkpoint: place reducers fresh
                eng._hosts.assign(eng.plan.total_reducers)
        # loads are arrivals-per-epoch telemetry (they include expired and
        # migrated arrivals), not derivable from the retained rebuild
        eng._loads = np.asarray(flat["loads"]).astype(np.int64)
        return eng


# the classes a stream checkpoint's pickled blobs hold, by module under the
# package: the plan and its parts, the batch and recovery reports
_BLOB_CLASSES = {
    "core.cost": ("CostExpression",),
    "core.planner": ("ResidualPlan", "SharesSkewPlan"),
    "core.residual": ("Combination",),
    "core.schema": ("JoinQuery", "RelationSchema"),
    "core.shares": ("SharesSolution",),
    "stream.engine": ("BatchReport",),
    "stream.recovery": ("RecoveryReport",),
}


# the numpy names an array or a numpy scalar pickles through, under
# numpy 1 (``numpy.core``) and numpy 2 (``numpy._core``)
_NUMPY_NAMES = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.multiarray", fn)
    for core in ("core", "_core") for fn in ("_reconstruct", "scalar")
}


class _PortUnpickler(pickle.Unpickler):
    """Reads a checkpoint's pickled plan, reports and recovery reports,
    whichever package wrote them.  A class the JAX package pickled,
    ``repro.<mod>.<name>``, is read as the port's
    ``repro_torch.<mod>.<name>``, as is the port's own, for the classes in
    ``_BLOB_CLASSES``.  The numpy names of ``_NUMPY_NAMES``, numpy's dtype
    classes and the builtin classes pass; every other name is refused, and
    no ``repro`` module is ever imported."""

    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        if module == "numpy.dtypes":
            obj = getattr(getattr(np, "dtypes", None), name, None)
            if isinstance(obj, type) and issubclass(obj, np.dtype):
                return obj
        if module == "builtins":
            obj = super().find_class(module, name)
            if isinstance(obj, type):
                return obj
        pkg, _, rest = module.partition(".")
        if pkg in ("repro", "repro_torch") and name in _BLOB_CLASSES.get(rest, ()):
            return getattr(importlib.import_module(f"repro_torch.{rest}"), name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which this package does not read"
        )


def _pickle_blob(obj) -> np.ndarray:
    """``obj`` pickled as a uint8 array, its classes of ``_BLOB_CLASSES``
    named ``repro.<mod>.<name>`` as the JAX package's ``restore`` looks
    them up.  The pickler imports a class's own module to check it, so the
    port's are written first and their names rewritten after: protocol 3
    has no frames and names each class in a ``GLOBAL`` opcode, whose
    argument is spliced in place (protocol 2 would also rename builtins
    for Python 2).  Any other port class raises."""
    data = pickle.dumps(obj, protocol=3)
    out, last = [], 0
    for op, arg, pos in pickletools.genops(data):
        if op.name != "GLOBAL" or not arg.startswith("repro_torch."):
            continue
        module, name = arg.split(" ")
        rest = module[len("repro_torch."):]
        if name not in _BLOB_CLASSES.get(rest, ()):
            raise TypeError(f"a checkpoint blob cannot hold {module}.{name}")
        out.append(data[last:pos])
        out.append(f"c{'repro.' + rest}\n{name}\n".encode())
        last = pos + len(f"c{module}\n{name}\n")
    out.append(data[last:])
    return np.frombuffer(b"".join(out), dtype=np.uint8).copy()


def _unpickle(blob: np.ndarray):
    return _PortUnpickler(io.BytesIO(blob.tobytes())).load()
