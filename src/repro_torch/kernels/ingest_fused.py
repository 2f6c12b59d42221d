"""Fused streaming-ingest pass: CUDA kernels and their plain PyTorch versions
(DESIGN.md §7).

One pass over a relation's micro-batch computes what the streaming engine
needs from it:

  * ``dest [N, W]`` — the map phase's reducer ids (−1 = not emitted), the
    route table of ``mapreduce.keys`` evaluated per (row, column), columns
    residual-major and replica-minor as ``map_phase`` lays them out;
  * ``rank [N, W]`` — each emission's arrival index within its destination
    in flat row-major order (what a stable sort by destination gives), −1
    where ``dest`` is −1, and ``counts [K]`` per reducer: the pack plan that
    lets the engine scatter a batch into its bins without a sort;
  * ``cms [n_cols, depth, width]`` — the Count-Min increment of the
    sketched columns (``kernels.sketch_update``).

``fused_ingest_dense`` takes the routes as data, the int32 arrays of
``dense_route_encoding`` or the same checked once and packed on the card
by ``pack_routes`` (what a caller that makes many passes under one table
passes: the ``route_program`` the kernels read); ``fused_ingest`` takes the
static route table of ``mapreduce.keys.static_route_table`` and encodes it
the same way (``Wp = W``, ``V`` = its longest exclude list, packed once per
table), so one set of kernels (``csrc/ingest_fused.cu``) serves both, at
any ``k_pad`` that device memory holds (``launch_geometry`` sizes their
tiles).  On CUDA tensors the
wrappers launch it, and the Count-Min kernel (``csrc/cms_update.cu``) for
the sketch half; on CPU tensors they take the plain versions
``fused_ingest_dense_ref`` / ``fused_ingest_ref``.  A CUDA tensor never
falls back to a plain version.  ``LAUNCHES`` counts wrapper calls that
launched ``ingest_fused.cu``; ``fused_ingest``'s sketch-only calls, which
launch only the Count-Min kernel, count under ``fused_ingest_sketch``.

Every destination id must lie below ``k_pad`` (``num_reducers`` for the
static table): the wrappers bound the ids from the encoding and raise
otherwise, where a short histogram would corrupt ``counts`` and ``rank``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.mapreduce.hashing import bucket_torch, mix32_torch

from ._build import count_launch, library, reset_counts
from .block_join import _wrap_i32
from .sketch_update import cms_tables, cms_tables_ref

LAUNCHES = {"fused_ingest": 0, "fused_ingest_sketch": 0, "fused_ingest_dense": 0}

_M32 = 0xFFFFFFFF
_MIN_TILE = 2048  # emissions per tile below which a tile's fixed costs dominate
_TILES_PER_SM = 4  # tiles the passes aim for, per streaming multiprocessor
_TABLE_MAX = 1 << 24  # [tiles, k_pad] count-table entries past which tiles grow

# Route table entry (all static, as mapreduce.keys.static_route_table gives):
#   (offset, hashed, replica_offsets, pins, excludes)
#   hashed:  ((col, seed, dim, stride), ...)   attrs the tuple owns
#   replica_offsets: (int, ...)                flat grid offsets (the paper's
#                                              recursive_keys enumeration)
#   pins:    ((col, value), ...)               HH equality constraints
#   excludes:((col, (value, ...)), ...)        ordinary-type HH exclusions
RouteTable = tuple

_ENC_KEYS = (
    "col_base", "col_valid", "h_col", "h_seed", "h_dim", "h_stride",
    "p_col", "p_val", "p_on", "e_col", "e_val", "e_on",
)


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def route_width(routes: RouteTable) -> int:
    """Total emission width W = sum of per-residual replication."""
    return sum(len(rep) for _, _, rep, _, _ in routes)


def dense_route_encoding(
    routes: RouteTable,
    arity: int,
    w_pad: int,
    max_values: int,
) -> dict:
    """Encode a static route table as dense int32 arrays (dynamic operands).

    Shapes: per padded flat column ``w < w_pad`` (real columns first, in
    ``map_phase``'s residual-major/replica-minor order):

      * ``col_base [Wp]``   — residual offset + replica offset (0 padded)
      * ``col_valid [Wp]``  — 1 for real columns
      * ``h_col/h_seed/h_dim/h_stride [Wp, H]`` — hashed-attr terms, padded
        with (0, 0, 1, 0) so a padded slot contributes bucket 0 * stride 0
      * ``p_col/p_val/p_on [Wp, P]`` — pin equalities (``p_on=0`` ignored)
      * ``e_col [Wp, P]``, ``e_val/e_on [Wp, P, V]`` — exclude lists

    ``H = P = arity`` (a residual can hash/pin/exclude at most every
    attribute) and ``V = max_values`` must bound the per-attr exclude list
    (the planner's ``max_hh_per_attr``); violations raise rather than
    silently truncate.
    """
    w = route_width(routes)
    if w > w_pad:
        raise ValueError(f"w_pad {w_pad} < route width {w}")
    H = P = max(1, arity)
    V = max(1, max_values)
    enc = {
        "col_base": np.zeros(w_pad, np.int32),
        "col_valid": np.zeros(w_pad, np.int32),
        "h_col": np.zeros((w_pad, H), np.int32),
        "h_seed": np.zeros((w_pad, H), np.int32),
        "h_dim": np.ones((w_pad, H), np.int32),
        "h_stride": np.zeros((w_pad, H), np.int32),
        "p_col": np.zeros((w_pad, P), np.int32),
        "p_val": np.zeros((w_pad, P), np.int32),
        "p_on": np.zeros((w_pad, P), np.int32),
        "e_col": np.zeros((w_pad, P), np.int32),
        "e_val": np.zeros((w_pad, P, V), np.int32),
        "e_on": np.zeros((w_pad, P, V), np.int32),
    }
    col = 0
    for offset, hashed, rep, pins, excludes in routes:
        if len(hashed) > H or len(pins) > P or len(excludes) > P:
            raise ValueError(
                f"route terms exceed arity padding {H}: "
                f"{len(hashed)} hashed / {len(pins)} pins / "
                f"{len(excludes)} excludes"
            )
        for r_off in rep:
            enc["col_base"][col] = offset + r_off
            enc["col_valid"][col] = 1
            for j, (c, seed, dim, stride) in enumerate(hashed):
                enc["h_col"][col, j] = c
                enc["h_seed"][col, j] = np.int32(np.uint32(seed))
                enc["h_dim"][col, j] = dim
                enc["h_stride"][col, j] = stride
            for j, (c, value) in enumerate(pins):
                enc["p_col"][col, j] = c
                enc["p_val"][col, j] = value
                enc["p_on"][col, j] = 1
            for j, (c, values) in enumerate(excludes):
                if len(values) > V:
                    raise ValueError(
                        f"exclude list ({len(values)}) exceeds max_values "
                        f"padding ({V}); raise the pad_values hint"
                    )
                enc["e_col"][col, j] = c
                for v_i, hv in enumerate(values):
                    enc["e_val"][col, j, v_i] = hv
                    enc["e_on"][col, j, v_i] = 1
            col += 1
    return enc


# ---- plain versions -----------------------------------------------------------

def _rank_counts(dest: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank [N, W] int32, counts [k] int32) of a destination block: the
    rank of each valid emission within its destination after a stable sort
    of the flat row-major emissions, and the per-destination histogram."""
    flat = dest.reshape(-1).to(torch.int64)
    ok = flat >= 0
    key = torch.where(ok, flat, torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key, stable=True)
    first = torch.searchsorted(ks, ks, side="left")
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) - first
    rank = torch.where(ok, rank, -1).reshape(dest.shape).to(torch.int32)
    counts = torch.bincount(flat[ok], minlength=k).to(torch.int32)
    return rank, counts


def _dense_dest_ref(rows: torch.Tensor, t: dict) -> torch.Tensor:
    """[N, Wp] destinations from the dense encoding (int64 tensors ``t``)."""
    r = rows.to(torch.int64)
    bucket = mix32_torch(r[:, t["h_col"]], t["h_seed"]) % (t["h_dim"] & _M32)
    base = t["col_base"] + (bucket * t["h_stride"]).sum(-1)
    pin_ok = ((r[:, t["p_col"]] == t["p_val"]) | (t["p_on"] == 0)).all(-1)
    ev = r[:, t["e_col"]]
    bad = ((ev[..., None] == t["e_val"]) & (t["e_on"] != 0)).flatten(-2).any(-1)
    ok = (t["col_valid"] != 0) & pin_ok & ~bad
    return torch.where(ok, _wrap_i32(base), -1).to(torch.int32)


def _enc_tensors(enc: dict, device) -> dict:
    return {
        k: torch.as_tensor(np.asarray(enc[k]), device=device).to(torch.int64)
        for k in _ENC_KEYS
    }


def fused_ingest_dense_ref(
    rows: torch.Tensor,
    enc: dict,
    sketch_cols: tuple[int, ...] = (),
    seeds: tuple[int, ...] = (),
    width: int = 2048,
    k_pad: int = 128,
):
    """Plain version of ``fused_ingest_dense``: (dest [N, Wp], rank [N, Wp],
    counts [k_pad], cms [n_cols, depth, width] | None), int32."""
    dest = _dense_dest_ref(rows, _enc_tensors(enc, rows.device))
    rank, counts = _rank_counts(dest, k_pad)
    cms = cms_tables_ref(rows, sketch_cols, seeds, width) if sketch_cols else None
    return dest, rank, counts, cms


def fused_ingest_ref(
    rows: torch.Tensor,
    routes: RouteTable = (),
    sketch_cols: tuple[int, ...] = (),
    seeds: tuple[int, ...] = (),
    width: int = 2048,
    num_reducers: int = 1,
):
    """Plain version of ``fused_ingest``: (dest [N, W], rank [N, W], counts
    [num_reducers], cms [n_cols, depth, width]), int32; the route outputs
    are None without ``routes``, ``cms`` is None without ``sketch_cols``.

    ``dest`` evaluates the static table as ``RouteSpec.destinations`` does,
    independently of the dense encoding."""
    n = rows.shape[0]
    dest = rank = counts = cms = None
    if routes:
        blocks = []
        for offset, hashed, rep, pins, excludes in routes:
            base = torch.full((n,), int(offset), dtype=torch.int64, device=rows.device)
            for col, seed, dim, stride in hashed:
                base = base + bucket_torch(rows[:, col], seed, dim).to(torch.int64) * int(stride)
            ok = torch.ones(n, dtype=torch.bool, device=rows.device)
            for col, value in pins:
                ok &= rows[:, col] == int(value)
            for col, values in excludes:
                for hv in values:
                    ok &= rows[:, col] != int(hv)
            for r_off in rep:
                blocks.append(torch.where(ok, _wrap_i32(base + int(r_off)), -1).to(torch.int32))
        dest = torch.stack(blocks, dim=1)
        rank, counts = _rank_counts(dest, num_reducers)
    if sketch_cols:
        cms = cms_tables_ref(rows, sketch_cols, seeds, width)
    return dest, rank, counts, cms


# ---- wrappers -----------------------------------------------------------------

def _check_rows(rows: torch.Tensor) -> None:
    if rows.dtype != torch.int32:
        raise TypeError(f"fused_ingest: rows must be int32, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError("fused_ingest: rows must be [N, arity] with arity >= 1")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ingest: no kernel for device {rows.device}")


def _check_sketch(sketch_cols, seeds) -> None:
    if sketch_cols and not seeds:
        raise ValueError("sketching requires the Count-Min row seeds")


@dataclass(frozen=True, eq=False)
class DenseRoutes:
    """A dense encoding, checked once and (on the card) packed for the
    kernel: ``fused_ingest_dense`` takes it in place of the array dict, so
    a caller that makes many passes under one route table checks and
    uploads it once."""

    arrays: dict  # the dense_route_encoding arrays (host numpy)
    wp: int  # route columns
    ids: int  # destination ids the table can emit: k_pad must reach it
    cols: int  # row columns the table reads: the rows' arity must reach it
    packed: torch.Tensor | None  # int32, route_program(arrays); None off the card


def _check_enc(enc: dict) -> tuple[tuple[int, int, int, int], int, int]:
    """Validate a dense encoding: ((Wp, H, P, V), destination ids it can
    emit, row columns it reads)."""
    a = {k: np.asarray(enc[k]) for k in _ENC_KEYS}
    if a["col_base"].ndim != 1:
        raise ValueError("fused_ingest: col_base must be [Wp]")
    wp = a["col_base"].shape[0]
    h = a["h_col"].shape[1] if a["h_col"].ndim == 2 else -1
    p = a["p_col"].shape[1] if a["p_col"].ndim == 2 else -1
    v = a["e_val"].shape[2] if a["e_val"].ndim == 3 else -1
    shapes = {
        "col_valid": (wp,), "h_col": (wp, h), "h_seed": (wp, h), "h_dim": (wp, h),
        "h_stride": (wp, h), "p_col": (wp, p), "p_val": (wp, p), "p_on": (wp, p),
        "e_col": (wp, p), "e_val": (wp, p, v), "e_on": (wp, p, v),
    }
    for k, shape in shapes.items():
        if a[k].shape != shape or min(shape) < 1:
            raise ValueError(f"fused_ingest: encoding {k} has shape {a[k].shape}, wants {shape}")
    if (a["h_col"] < 0).any() or (a["p_col"] < 0).any() or (a["e_col"] < 0).any():
        raise ValueError("fused_ingest: a negative column index")
    cols = 1 + max(int(a[k].max()) for k in ("h_col", "p_col", "e_col"))
    if (a["h_dim"] < 1).any():
        raise ValueError("fused_ingest: every h_dim must be >= 1")
    live = a["col_valid"] != 0
    ids = 0
    if live.any():
        if (a["col_base"][live] < 0).any() or (a["h_stride"][live] < 0).any():
            raise ValueError("fused_ingest: negative col_base or h_stride")
        top = a["col_base"].astype(np.int64) + (
            (a["h_dim"].astype(np.int64) - 1) * a["h_stride"].astype(np.int64)
        ).sum(-1)
        ids = int(top[live].max()) + 1
    return (wp, h, p, v), ids, cols


def divisor_magic(d: int) -> tuple[int, int]:
    """(magic, shift) for the unsigned 32-bit division x // d, 2 <= d < 2^32,
    as ``(hi + ((x - hi) >> 1)) >> shift`` with ``hi = (x * magic) >> 32``
    (Granlund and Montgomery 1994, figure 4.1): the kernels' modulo by a
    hashed dimension."""
    if not 2 <= d < 1 << 32:
        raise ValueError(f"divisor_magic: d={d} outside [2, 2^32)")
    lg = (d - 1).bit_length()  # ceil(log2 d)
    return ((1 << 32) * ((1 << lg) - d)) // d + 1, lg - 1


def route_program(enc: dict) -> np.ndarray:
    """The route program the kernels read: a checked dense encoding
    compiled into int32 words, four at a time (int4).

    Columns are compiled in groups: a run of consecutive columns with the
    same tests and hashed terms (the replicas of one residual, which differ
    only in their base), or a run of padded columns, so a row's terms are
    evaluated once a group.  int4 0 is ``(groups, Wp, bases, owners)``;
    int4s ``1 + 2g`` and ``2 + 2g`` are group g's ``(first column,
    columns, tests, hashed)`` and ``(first term, 0, 0, 0)``, ``tests = -1``
    for padded columns; from int4 ``bases`` the Wp columns' bases, from
    int4 ``owners`` each column's group (Wp words each, padded to whole
    int4s); then the groups' terms, tests first.  A test is ``(col, value,
    must_equal, 0)``: a pin that is on (the row's value must equal it) or
    an exclude value that is on (it must not).  A hashed term is ``(col,
    seed, dim, stride), (magic, shift, 0, 0)`` (``divisor_magic(dim)``);
    terms whose stride is 0 or whose dim is 1 add 0 to the destination and
    are left out."""
    a = {k: np.asarray(enc[k]).astype(np.int64) for k in _ENC_KEYS}
    wp, h = a["h_col"].shape
    p, v = a["e_val"].shape[1:]
    groups = []  # [first column, columns, (tests, hashed terms) or None]
    for w in range(wp):
        terms = None
        if a["col_valid"][w] != 0:
            tests = [(a["p_col"][w, j], a["p_val"][w, j], 1, 0)
                     for j in range(p) if a["p_on"][w, j]]
            tests += [(a["e_col"][w, j], a["e_val"][w, j, t], 0, 0)
                      for j in range(p) for t in range(v) if a["e_on"][w, j, t]]
            hashed = []
            for j in range(h):
                dim, stride = int(a["h_dim"][w, j]), int(a["h_stride"][w, j])
                if stride != 0 and dim != 1:
                    hashed += [(a["h_col"][w, j], a["h_seed"][w, j], dim, stride),
                               (*divisor_magic(dim), 0, 0)]
            terms = (tuple(tuple(map(int, x)) for x in tests),
                     tuple(tuple(map(int, x)) for x in hashed))
        if groups and groups[-1][2] == terms:
            groups[-1][1] += 1
        else:
            groups.append([w, 1, terms])
    n_g, quads = len(groups), -(-wp // 4)
    bases_at, owners_at = 1 + 2 * n_g, 1 + 2 * n_g + quads
    head = [(n_g, wp, bases_at, owners_at)]
    owners = np.zeros(4 * quads, np.int64)
    body = []
    for g, (first, count, terms) in enumerate(groups):
        owners[first:first + count] = g
        if terms is None:
            head += [(first, count, -1, 0), (0, 0, 0, 0)]
            continue
        tests, hashed = terms
        head += [(first, count, len(tests), len(hashed) // 2),
                 (owners_at + quads + len(body), 0, 0, 0)]
        body += list(tests) + list(hashed)
    bases = np.zeros(4 * quads, np.int64)
    bases[:wp] = a["col_base"]
    words = np.concatenate([np.asarray(head, np.int64).reshape(-1, 4), bases.reshape(-1, 4),
                            owners.reshape(-1, 4), np.asarray(body, np.int64).reshape(-1, 4)])
    return (words & _M32).astype(np.uint32).view(np.int32).reshape(-1)


def pack_routes(enc, device) -> DenseRoutes:
    """Check a ``dense_route_encoding`` once and, for a CUDA device, upload
    its ``route_program`` for the kernels."""
    if isinstance(enc, DenseRoutes):
        return enc
    (wp, *_), ids, cols = _check_enc(enc)
    packed = None
    if torch.device(device).type == "cuda":
        packed = torch.from_numpy(route_program(enc)).to(device)
    return DenseRoutes(enc, wp, ids, cols, packed)


def _check_fit(routes: DenseRoutes, rows: torch.Tensor, k_pad: int) -> None:
    if routes.cols > rows.shape[1]:
        raise ValueError(
            f"fused_ingest: the routes read column {routes.cols - 1}, outside the "
            f"rows' {rows.shape[1]}"
        )
    if routes.ids > k_pad:
        raise ValueError(
            f"fused_ingest: destination ids reach {routes.ids - 1}, but only {k_pad} "
            "are counted: k_pad (num_reducers) must cover every destination"
        )
    if rows.device.type == "cuda" and (
        routes.packed is None or routes.packed.device != rows.device
    ):
        raise ValueError(f"fused_ingest: routes not packed for {rows.device}")


def launch_geometry(n: int, wp: int, arity: int, k_pad: int, sms: int, max_tile: int,
                    max_row_words: int) -> int:
    """Rows per tile of the count and rank kernels, for ``n`` rows of
    ``arity`` values, ``wp`` route columns, ``k_pad`` destinations and a
    card of ``sms`` multiprocessors: about ``_TILES_PER_SM`` tiles an SM,
    none under ``_MIN_TILE`` emissions; fewer, larger tiles where the
    [tiles, k_pad] count table would outgrow ``_TABLE_MAX``; never more than
    ``max_tile`` emissions or ``max_row_words`` words of rows a tile (the
    kernels' limits, ``tile_limits``), past which the table grows instead."""
    if wp > max_tile or arity > max_row_words:
        raise ValueError(
            f"fused_ingest: {wp} columns or rows of {arity} values exceed the kernel's "
            f"{max_tile} emissions and {max_row_words} words of rows per tile"
        )
    rpt = max(-(-n // (_TILES_PER_SM * sms)), -(-_MIN_TILE // wp))
    rpt = max(rpt, -(-n // max(1, _TABLE_MAX // k_pad)))
    return max(1, min(rpt, n, max_tile // wp, max_row_words // arity))


@functools.lru_cache(maxsize=None)
def tile_limits() -> tuple[int, int]:
    """(emissions, words of rows) a tile at most, as the built kernels
    define them: the rank kernel's 16-bit counters and the count kernel's
    staging."""
    lib = library("ingest_fused")
    return lib.ingest_max_tile(), lib.ingest_max_row_words()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rows_per_tile(n: int, wp: int, arity: int, k_pad: int, device: torch.device) -> int:
    """launch_geometry on ``device``'s card with the kernels' own limits."""
    return launch_geometry(n, wp, arity, k_pad, _sm_count(device), *tile_limits())


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of the count, scan and rank kernels, typed once."""
    fn = library("ingest_fused").ingest_launch
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(rows, routes: DenseRoutes, k_pad):
    """The destination/rank kernels on the card: (dest, rank, counts).  The
    [tiles, k_pad] count table is scratch; a k_pad whose table device
    memory cannot hold raises PyTorch's out-of-memory error here."""
    n = rows.shape[0]
    wp = routes.wp
    dev = rows.device
    if n * wp >= 1 << 31:
        raise ValueError(f"fused_ingest: {n} x {wp} emissions exceed 2^31")
    rpt = rows_per_tile(n, wp, rows.shape[1], k_pad, dev)
    dest = torch.empty((n, wp), dtype=torch.int32, device=dev)
    rank = torch.empty((n, wp), dtype=torch.int32, device=dev)
    counts = torch.empty(k_pad, dtype=torch.int32, device=dev)
    table = torch.empty((-(-n // rpt), k_pad), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(
            rows.data_ptr(), n, rows.shape[1], routes.packed.data_ptr(), wp, k_pad, rpt,
            dest.data_ptr(), rank.data_ptr(), counts.data_ptr(), table.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ingest kernel launch failed: cudaError {err}")
    return dest, rank, counts


def fused_ingest_dense(
    rows: torch.Tensor,  # [N, arity] int32
    enc,  # dense_route_encoding arrays, or pack_routes of them
    sketch_cols: tuple[int, ...] = (),
    seeds: tuple[int, ...] = (),
    width: int = 2048,
    k_pad: int = 128,
):
    """One fused pass with the routes as data: ``(dest [N, Wp], rank
    [N, Wp], counts [k_pad], cms [n_cols, depth, width] | None)``, int32.
    ``k_pad`` exceeds every destination id."""
    _check_rows(rows)
    _check_sketch(sketch_cols, seeds)
    if k_pad < 1:
        raise ValueError(f"fused_ingest_dense: k_pad={k_pad} must be positive")
    routes = pack_routes(enc, rows.device)
    _check_fit(routes, rows, k_pad)
    if rows.device.type == "cpu":
        return fused_ingest_dense_ref(rows, routes.arrays, sketch_cols, seeds, width, k_pad)
    rows = rows.contiguous()
    if rows.shape[0] == 0:
        z = torch.zeros((0, routes.wp), dtype=torch.int32, device=rows.device)
        cms = cms_tables(rows, sketch_cols, seeds, width) if sketch_cols else None
        return z, z.clone(), torch.zeros(k_pad, dtype=torch.int32, device=rows.device), cms
    dest, rank, counts = _launch(rows, routes, k_pad)
    cms = cms_tables(rows, sketch_cols, seeds, width) if sketch_cols else None
    count_launch(LAUNCHES, "fused_ingest_dense")
    return dest, rank, counts, cms


@functools.lru_cache(maxsize=16)
def _static_routes(routes: RouteTable, arity: int, device: torch.device) -> DenseRoutes:
    """A static table's dense encoding (``Wp = W``, ``V`` = its longest
    exclude list), packed once per (table, arity, device)."""
    longest = max((len(vs) for *_, ex in routes for _, vs in ex), default=1)
    enc = dense_route_encoding(routes, arity, route_width(routes), max_values=longest)
    return pack_routes(enc, device)


def fused_ingest(
    rows: torch.Tensor,  # [N, arity] int32
    routes: RouteTable = (),
    sketch_cols: tuple[int, ...] = (),
    seeds: tuple[int, ...] = (),
    width: int = 2048,
    num_reducers: int = 1,
):
    """One fused pass with a static route table: ``(dest [N, W], rank
    [N, W], counts [num_reducers], cms [n_cols, depth, width])``; the route
    outputs are None without ``routes`` (sketch only), ``cms`` is None
    without ``sketch_cols`` (routes only)."""
    if not routes and not sketch_cols:
        raise ValueError("fused ingest needs routes and/or sketch_cols")
    _check_rows(rows)
    _check_sketch(sketch_cols, seeds)
    packed = None
    if routes:
        packed = _static_routes(routes, rows.shape[1], rows.device)
        _check_fit(packed, rows, num_reducers)
    if rows.device.type == "cpu":
        return fused_ingest_ref(rows, routes, sketch_cols, seeds, width, num_reducers)
    rows = rows.contiguous()
    n = rows.shape[0]
    dest = rank = counts = cms = None
    if routes:
        if n == 0:
            dest = torch.zeros((0, packed.wp), dtype=torch.int32, device=rows.device)
            rank = dest.clone()
            counts = torch.zeros(num_reducers, dtype=torch.int32, device=rows.device)
        else:
            dest, rank, counts = _launch(rows, packed, num_reducers)
            count_launch(LAUNCHES, "fused_ingest")
    if sketch_cols:
        cms = cms_tables(rows, sketch_cols, seeds, width)
        if n and not routes:
            count_launch(LAUNCHES, "fused_ingest_sketch")
    return dest, rank, counts, cms
