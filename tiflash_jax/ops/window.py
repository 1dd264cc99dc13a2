"""Window functions over whole sorted columns.

Role analog: ``dbms/src/WindowFunctions/`` (``IWindowFunction``) plus the
partition/peer-group advance logic of ``WindowTransformAction``
(``DataStreams/WindowTransformAction.h``) — re-imagined as one whole-batch
computation: a single lexicographic ``lax.sort`` by (partition keys, order
keys) replaces the streaming partition tracker, and every window function
becomes a *segmented scan/gather* over the sorted batch:

- row_number  = position - partition_start
- rank        = position of peer-group start - partition_start + 1
- dense_rank  = segmented count of peer-group boundaries
- lead/lag    = shifted gather with partition-boundary masking
- first_value = gather at partition_start
- sum/count/min/max (unbounded preceding .. current row frame) =
  segmented prefix scan (associative_scan with boundary reset)

The reference forces fine-grained shuffle ahead of window execution
(``Flash/Planner/Plans/PhysicalWindow.cpp``); the distributed analog here
is a hash exchange on the partition keys so each device owns whole
partitions, then this local kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.block import Block, Column
from ..core.dtypes import DataType, INT64, TypeKind
from .sort import SortKey, _sort_operand


@dataclasses.dataclass(frozen=True)
class WindowDesc:
    """func ∈ {row_number, rank, dense_rank, lead, lag, first_value,
    last_value, sum, count, min, max, avg}; ``arg`` names the value column
    where applicable; lead/lag take ``offset`` and optional ``default``.

    ``frame``: (preceding, following) bounds for sum/count/avg/min/max.
    ``frame_type`` selects the unit: "rows" counts rows; "range" measures
    ORDER-BY *value* distance (reference ``WindowTransformAction.h:122-146``
    ``stepToStartForRangeFrame``) and requires exactly one numeric order
    key — offsets are in the column's physical unit (mantissa steps for
    decimals, days for dates).  A None bound = UNBOUNDED on that side; a 0
    range bound = CURRENT ROW *including peers* (SQL RANGE semantics).
    frame=None = unbounded preceding .. current row (running default)."""

    func: str
    name: str
    arg: Optional[str] = None
    offset: int = 1
    default: Optional[object] = None
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    frame_type: str = "rows"


def _running_count(validity: Optional[jnp.ndarray], n: int) -> jnp.ndarray:
    """Inclusive running count of valid rows.  Without a validity mask it
    is an iota: XLA's GPU compiler constant-folds a cumsum of a constant
    array at compile time, in time quadratic in the row count."""
    if validity is None:
        return jnp.arange(1, n + 1, dtype=jnp.int64)
    return jnp.cumsum(validity.astype(jnp.int64))


def _reset_at_segments(ps: jnp.ndarray, seg_start: jnp.ndarray) -> jnp.ndarray:
    """An inclusive integer prefix sum restarted at every segment start."""
    from .segments import forward_fill_positions

    start = forward_fill_positions(seg_start)
    before = jnp.where(start > 0, jnp.take(ps, jnp.maximum(start - 1, 0)), 0)
    return ps - before


def _segmented_prefix(op: str, vals: jnp.ndarray, seg_start: jnp.ndarray) -> jnp.ndarray:
    """Inclusive segmented scan: resets at rows where seg_start is True.

    Integer sums use a plain cumsum differenced against the segment-start
    prefix (exact, and cheaper than an associative_scan); float
    sums and min/max run the boundary-resetting associative scan (floats
    would cancel catastrophically under global differencing)."""
    if op == "sum" and not jnp.issubdtype(vals.dtype, jnp.floating):
        return _reset_at_segments(jnp.cumsum(vals), seg_start)

    def combine(a, b):
        a_flag, a_val = a
        b_flag, b_val = b
        if op == "sum":
            merged = a_val + b_val
        elif op == "min":
            merged = jnp.minimum(a_val, b_val)
        elif op == "max":
            merged = jnp.maximum(a_val, b_val)
        elif op == "band":
            merged = a_val & b_val
        elif op == "bor":
            merged = a_val | b_val
        elif op == "bxor":
            merged = a_val ^ b_val
        else:
            raise NotImplementedError(op)
        return a_flag | b_flag, jnp.where(b_flag, b_val, merged)

    _, out = jax.lax.associative_scan(combine, (seg_start, vals))
    return out


def _merge_count(data_keys, query_keys, right: bool) -> jnp.ndarray:
    """#data rows with lexicographic key < query (right=False) or
    <= query (right=True), for every query row.

    Both sequences are whole columns of the same batch; counting is one
    combined ``lax.sort`` of 2n rows (a tie-break tag orders queries
    before/after equal data keys) + one sort back to query order — the
    device replacement for WindowTransformAction's per-row
    ``stepToStartForRangeFrame`` walk: O(n log n) total instead of a
    data-dependent pointer chase per row."""
    n = data_keys[0].shape[0]
    tag_d = jnp.full(n, 0 if right else 1, dtype=jnp.int8)
    tag_q = jnp.full(n, 1 if right else 0, dtype=jnp.int8)
    ops = [jnp.concatenate([d, q]) for d, q in zip(data_keys, query_keys)]
    ops.append(jnp.concatenate([tag_d, tag_q]))
    is_data = jnp.concatenate(
        [jnp.ones(n, jnp.int32), jnp.zeros(n, jnp.int32)]
    )
    orig = jnp.concatenate([jnp.arange(n, dtype=jnp.int32)] * 2)
    s = jax.lax.sort(tuple(ops) + (is_data, orig), num_keys=len(ops),
                     is_stable=True)
    cnt_at = jnp.cumsum(s[-2])  # inclusive: at a query slot == #data before
    back = jax.lax.sort((s[-2], s[-1], cnt_at), num_keys=2, is_stable=True)
    return back[2][:n].astype(jnp.int64)


def _range_bounds(
    order_ops: List[jnp.ndarray],
    part_start_idx: jnp.ndarray,
    part_end_idx: jnp.ndarray,
    prec: Optional[int],
    foll: Optional[int],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RANGE-frame (lo, hi) row indices from the sorted order-key operands.

    ``order_ops`` are the order key's ascending-transformed sort operands
    ([null_rank,] value'); offsets are uniform in the transformed space
    for ASC and DESC alike (DESC flips via ~v / -v, so value-distance
    windows map to v' -/+ offset unchanged).  NULL order keys carry a
    distinct null_rank operand, which confines their frame to the null
    peer set (MySQL RANGE-with-NULL semantics) for free.  The partition id
    leads the key, so counts ARE global row indices — no per-partition
    clamping needed."""
    vals = order_ops[-1]
    if not jnp.issubdtype(vals.dtype, jnp.floating):
        vals = vals.astype(jnp.int64)
    lead = [part_start_idx] + [o for o in order_ops[:-1]]
    if prec is None:
        lo = part_start_idx
    else:
        lo = _merge_count(lead + [vals], lead + [vals - prec], right=False)
    if foll is None:
        hi = part_end_idx
    else:
        hi = _merge_count(lead + [vals], lead + [vals + foll], right=True) - 1
    return lo, hi


def window_block(
    block: Block,
    partition_by: Sequence[str],
    order_by: Sequence[SortKey],
    funcs: Sequence[WindowDesc],
) -> Block:
    """Compute all window functions; output rows sorted by (partition,
    order) with dead rows pushed to the end (sel-compacted like sort)."""
    n = block.capacity
    live = block.sel_mask()

    operands: List[jnp.ndarray] = [~live]
    n_part_ops = 1
    for name in partition_by:
        c = block[name]
        if c.validity is not None:
            operands.append(~c.validity)
            # canonicalize NULL slots (join payloads carry garbage data
            # under validity=False) so one NULL partition, not many
            operands.append(jnp.where(c.validity, c.data,
                                      jnp.zeros_like(c.data)))
        else:
            operands.append(c.data)
    n_part_ops = len(operands)
    for sk in order_by:
        operands.extend(_sort_operand(block[sk.name], sk.desc, sk.nulls_first_resolved))
    n_sort_ops = len(operands)
    operands.append(jnp.arange(n, dtype=jnp.int32))
    out = jax.lax.sort(tuple(operands), num_keys=n_sort_ops, is_stable=True)
    perm = out[-1]
    sorted_ops = out[:-1]
    sblock = block.take(perm)
    live_s = jnp.take(live, perm)
    count = jnp.sum(live, dtype=jnp.int32)
    sel = jnp.arange(n, dtype=jnp.int32) < count

    # partition boundaries (first n_part_ops operands), peer boundaries (all
    # sort operands)
    def boundaries(ops):
        neq = jnp.zeros(n, dtype=jnp.bool_)
        for arr in ops:
            neq = neq | (arr != jnp.roll(arr, 1))
        return neq.at[0].set(True)

    part_start = boundaries(sorted_ops[:n_part_ops])
    peer_start = boundaries(sorted_ops[:n_sort_ops])

    from .segments import backward_fill_positions, forward_fill_positions

    pos = jnp.arange(n, dtype=jnp.int64)
    # index of this row's partition start / peer-group start
    part_start_idx = forward_fill_positions(part_start).astype(jnp.int64)
    peer_start_idx = forward_fill_positions(peer_start).astype(jnp.int64)
    # partition end (backward fill of last-row flags) and sizes
    _last_flag = jnp.roll(part_start, -1).at[n - 1].set(True)
    part_end_idx = backward_fill_positions(_last_flag).astype(jnp.int64)
    part_size = part_end_idx - part_start_idx + 1
    # peer-group end (for cume_dist)
    _peer_last = jnp.roll(peer_start, -1).at[n - 1].set(True)
    peer_end_idx = backward_fill_positions(_peer_last).astype(jnp.int64)

    out_cols = dict(zip(sblock.names, sblock.columns))

    def frame_lo_hi(f: WindowDesc) -> Tuple[jnp.ndarray, jnp.ndarray]:
        prec, foll = f.frame
        if f.frame_type == "range":
            if len(order_by) != 1:
                raise NotImplementedError(
                    "RANGE frames require exactly one order key"
                )
            lo, hi = _range_bounds(
                list(sorted_ops[n_part_ops:n_sort_ops]),
                part_start_idx, part_end_idx, prec, foll,
            )
            oc = sblock[order_by[0].name]
            if oc.validity is not None:
                # MySQL RANGE-with-NULL: a NULL-key row's frame is its
                # whole null peer set regardless of the offsets (value
                # arithmetic would otherwise exclude it for frames not
                # containing the current value, e.g. 1 FOLLOWING..2
                # FOLLOWING)
                isn = ~oc.validity
                if prec is not None:
                    lo = jnp.where(isn, peer_start_idx, lo)
                if foll is not None:
                    hi = jnp.where(isn, peer_end_idx, hi)
            return lo, hi
        lo = part_start_idx if prec is None else jnp.maximum(
            pos - prec, part_start_idx)
        hi = part_end_idx if foll is None else jnp.minimum(
            pos + foll, part_end_idx)
        return lo, hi

    # ---- batched frame-aggregate prefix reads -------------------------
    # Frames are clamped into their partition, so for integer data a
    # GLOBAL cumsum difference G[hi] - G[lo-1] never crosses a segment —
    # no boundary-reset scan, no per-prefix start gathers.  All frame
    # sum/count/avg prefixes stack into ONE (n, k) int64 matrix read by
    # ONE row gather at hi and one at lo-1 (packing k lanes into one
    # gather pays the per-row gather cost once).
    frame_aggs = [f for f in funcs
                  if f.func in ("sum", "count", "avg") and f.frame is not None]
    run_aggs = [f for f in funcs
                if f.frame is None and (
                    f.func == "count"
                    or (f.func in ("sum", "avg")
                        and not sblock[f.arg].dtype.is_float))]
    frame_reads: dict = {}
    run_specs: dict = {}
    if frame_aggs or run_aggs:
        lanes: List[jnp.ndarray] = []
        specs: dict = {}  # f.name -> (cnt_lane, sum_lane | None, float_sum?)
        fl_specs: dict = {}
        for f in frame_aggs + run_aggs:
            c = sblock[f.arg] if f.arg else None
            cnt_lane = len(lanes)
            lanes.append(_running_count(None if c is None else c.validity, n))
            sum_lane = None
            is_float = False
            if f.func in ("sum", "avg"):
                is_float = c.dtype.is_float
                if is_float:
                    # float sums keep the boundary-reset scan (global
                    # differencing cancels catastrophically) and read it
                    # per-row below — rare path
                    vals = c.data.astype(jnp.float64)
                    if c.validity is not None:
                        vals = jnp.where(c.validity, vals, 0.0)
                    fl_specs[f.name] = _segmented_prefix("sum", vals, part_start)
                else:
                    vals = c.data.astype(jnp.int64)
                    if c.validity is not None:
                        vals = jnp.where(c.validity, vals, 0)
                    sum_lane = len(lanes)
                    lanes.append(jnp.cumsum(vals))
            specs[f.name] = (cnt_lane, sum_lane, is_float)
        G = jnp.stack(lanes, axis=1) if len(lanes) > 1 else lanes[0][:, None]
        by_frame: dict = {}
        for f in frame_aggs:
            key = (f.frame, f.frame_type)
            if key not in by_frame:
                lo, hi = frame_lo_hi(f)
                empty = hi < lo  # e.g. 3 PRECEDING..1 PRECEDING at the
                # partition start, or hi clamped below the partition
                at_hi = jnp.take(G, jnp.clip(hi, 0, n - 1).astype(
                    jnp.int32), axis=0)
                lom1 = jnp.maximum(lo - 1, 0).astype(jnp.int32)
                at_lo_raw = jnp.take(G, lom1, axis=0)
                at_lo = jnp.where((lo > 0)[:, None], at_lo_raw, 0)
                by_frame[key] = jnp.where(empty[:, None], 0,
                                          at_hi - at_lo)
            frame_reads[f.name] = by_frame[(f.frame, f.frame_type)]
        if run_aggs:
            # running (unbounded preceding .. current): G[pos] minus the
            # value just before the partition start — ONE packed gather
            # shared by every running sum/count
            psm1 = jnp.maximum(part_start_idx - 1, 0).astype(jnp.int32)
            at_ps = jnp.where((part_start_idx > 0)[:, None],
                              jnp.take(G, psm1, axis=0), 0)
            # SQL's default frame with ORDER BY is RANGE UNBOUNDED
            # PRECEDING..CURRENT ROW — peers INCLUDED: read the prefix
            # at the PEER-GROUP END, not at this row
            pe32 = peer_end_idx.astype(jnp.int32)
            for f in run_aggs:
                cnt_lane, sum_lane, _ = specs[f.name]
                run_specs[f.name] = (
                    jnp.take(lanes[cnt_lane], pe32) - at_ps[:, cnt_lane],
                    None if sum_lane is None
                    else jnp.take(lanes[sum_lane], pe32)
                    - at_ps[:, sum_lane],
                )

        def _frame_lane(f, lane):
            return frame_reads[f.name][:, lane]

    for f in funcs:
        if f.func == "row_number":
            data = pos - part_start_idx + 1
            out_cols[f.name] = Column(data.astype(jnp.int64), None, INT64)
        elif f.func == "rank":
            data = peer_start_idx - part_start_idx + 1
            out_cols[f.name] = Column(data.astype(jnp.int64), None, INT64)
        elif f.func == "dense_rank":
            # count peer boundaries within the partition up to this row
            peers_cum = jnp.cumsum(peer_start.astype(jnp.int64))
            peers_at_pstart = jnp.take(peers_cum, part_start_idx)
            data = peers_cum - peers_at_pstart + 1
            out_cols[f.name] = Column(data, None, INT64)
        elif f.func == "percent_rank":
            rank = (peer_start_idx - part_start_idx).astype(jnp.float64)
            denom = jnp.maximum(part_size - 1, 1).astype(jnp.float64)
            out_cols[f.name] = Column(
                rank / denom, None, DataType(TypeKind.FLOAT64)
            )
        elif f.func == "cume_dist":
            le_peers = (peer_end_idx - part_start_idx + 1).astype(jnp.float64)
            out_cols[f.name] = Column(
                le_peers / part_size.astype(jnp.float64), None,
                DataType(TypeKind.FLOAT64),
            )
        elif f.func == "ntile":
            k = jnp.int64(f.offset)  # bucket count rides in `offset`
            rn0 = pos - part_start_idx
            # MySQL ntile: first (size % k) buckets get ceil(size/k) rows
            q, r = part_size // k, part_size % k
            big = (q + 1) * r
            bucket = jnp.where(
                rn0 < big,
                rn0 // jnp.maximum(q + 1, 1),
                jnp.where(q > 0, r + (rn0 - big) // jnp.maximum(q, 1), rn0),
            )
            out_cols[f.name] = Column(bucket + 1, None, INT64)
        elif f.func in ("lead", "lag"):
            c = sblock[f.arg]
            shift = f.offset if f.func == "lag" else -f.offset
            src_raw = pos - shift
            in_range = (src_raw >= 0) & (src_raw < n)
            src = jnp.clip(src_raw, 0, n - 1).astype(jnp.int32)
            moved = jnp.take(c.data, src)
            moved_valid = (
                jnp.take(c.validity, src) if c.validity is not None else None
            )
            # out of partition -> default/NULL
            same_part = jnp.take(part_start_idx, src) == part_start_idx
            ok = same_part & in_range
            if f.default is not None:
                data = jnp.where(ok, moved, jnp.asarray(f.default, dtype=c.data.dtype))
                validity = None if moved_valid is None else jnp.where(ok, moved_valid, True)
                dt = c.dtype
            else:
                data = jnp.where(ok, moved, jnp.zeros_like(moved))
                validity = ok if moved_valid is None else (ok & moved_valid)
                dt = c.dtype.with_nullable(True)
            out_cols[f.name] = Column(data, validity, dt, c.dictionary)
        elif f.func in ("first_value", "last_value"):
            c = sblock[f.arg]
            if f.frame is not None:
                # explicit ROWS/RANGE frame: first/last row OF THE FRAME
                # (reference ``WindowTransformAction`` first/last over
                # the advanced frame); an empty frame yields NULL
                lo, hi = frame_lo_hi(f)
                tgt = lo if f.func == "first_value" else hi
                ok = lo <= hi
                idx = jnp.clip(tgt, 0, n - 1).astype(jnp.int32)
                data = jnp.take(c.data, jnp.where(ok, idx, 0))
                validity = ok if c.validity is None else (
                    ok & jnp.take(c.validity, idx))
                out_cols[f.name] = Column(
                    jnp.where(ok, data, jnp.zeros_like(data)), validity,
                    c.dtype.with_nullable(True), c.dictionary)
            else:
                if f.func == "first_value":
                    idx = part_start_idx.astype(jnp.int32)
                else:
                    # default frame: RANGE unbounded preceding ..
                    # current row — the current row's last PEER
                    idx = peer_end_idx.astype(jnp.int32)
                data = jnp.take(c.data, idx)
                validity = (jnp.take(c.validity, idx)
                            if c.validity is not None else None)
                out_cols[f.name] = Column(data, validity, c.dtype,
                                          c.dictionary)
        elif f.func == "nth_value":
            # NTH_VALUE(arg, n): n-th row of the frame (default frame:
            # unbounded preceding .. current row); NULL before the n-th
            # row arrives.  ``offset`` carries n (1-based, MySQL).
            c = sblock[f.arg]
            nth = max(int(f.offset), 1)
            if f.frame is not None:
                lo, hi = frame_lo_hi(f)
            else:
                lo, hi = part_start_idx, pos
            tgt = lo + (nth - 1)
            ok = tgt <= hi
            idx = jnp.clip(tgt, 0, n - 1).astype(jnp.int32)
            data = jnp.take(c.data, idx)
            validity = ok if c.validity is None else (
                ok & jnp.take(c.validity, idx)
            )
            out_cols[f.name] = Column(
                jnp.where(ok, data, jnp.zeros_like(data)), validity,
                c.dtype.with_nullable(True), c.dictionary,
            )
        elif f.func in ("min", "max") and f.frame is not None:
            # Bounded ROWS frame min/max: sparse table (doubling).  Level j
            # holds the reduction over [i, i+2^j); a frame [lo, hi] (already
            # clamped to the partition) is covered by two overlapping
            # level-j blocks with j = floor(log2(len)).  Build is
            # log2(frame width) shifted reductions; query is two flat
            # gathers — no per-row loops, frame length may vary freely at
            # partition edges.  (Reference: WindowTransformAction frame
            # advance recomputes per step; a sparse-table RMQ replaces it.)
            c = sblock[f.arg]
            lo, hi = frame_lo_hi(f)
            length = hi - lo + 1
            pc = _reset_at_segments(_running_count(c.validity, n), part_start)
            at_hi = jnp.take(pc, jnp.clip(hi, 0, n - 1).astype(jnp.int32))
            lom1 = jnp.clip(lo - 1, 0, n - 1).astype(jnp.int32)
            at_lo = jnp.where(lo > part_start_idx, jnp.take(pc, lom1), 0)
            cnt_f = at_hi - at_lo
            if c.dtype.is_float:
                ident = jnp.asarray(
                    jnp.inf if f.func == "min" else -jnp.inf, c.data.dtype
                )
            else:
                info = jnp.iinfo(c.data.dtype)
                ident = jnp.asarray(
                    info.max if f.func == "min" else info.min, c.data.dtype
                )
            vals = c.data if c.validity is None else jnp.where(
                c.validity, c.data, ident
            )
            reduce2 = jnp.minimum if f.func == "min" else jnp.maximum
            prec, foll = f.frame
            if f.frame_type == "range" or prec is None or foll is None:
                width = n  # value-distance / unbounded: any length possible
            else:
                width = int(prec) + int(foll) + 1
            levels = max(min(width, n), 1).bit_length()
            tables = [vals]
            for j in range(1, levels):
                d = 1 << (j - 1)
                prev = tables[-1]
                pad = jnp.full((min(d, n),), ident, prev.dtype)
                shifted = jnp.concatenate([prev[d:], pad])[:n]
                tables.append(reduce2(prev, shifted))
            T = jnp.stack(tables).reshape(-1)  # (levels*n,) flat
            safe_len = jnp.maximum(length, 1)
            j = jnp.floor(
                jnp.log2(safe_len.astype(jnp.float64))
            ).astype(jnp.int64)
            j = jnp.clip(j, 0, levels - 1)
            pw = jnp.int64(1) << j
            ga = jnp.take(T, jnp.clip(j * n + lo, 0, levels * n - 1).astype(jnp.int32))
            gb = jnp.take(
                T, jnp.clip(j * n + hi - pw + 1, 0, levels * n - 1).astype(jnp.int32)
            )
            red = reduce2(ga, gb)
            ok = (length > 0) & (cnt_f > 0)
            rdt = c.dtype.with_nullable(True)
            out_cols[f.name] = Column(
                jnp.where(ok, red, jnp.zeros_like(red)), ok, rdt, c.dictionary
            )
        elif f.func in ("sum", "count", "avg") and f.frame is not None:
            c = sblock[f.arg] if f.arg else None
            cnt_lane, sum_lane, is_float = specs[f.name]
            cnt_f = _frame_lane(f, cnt_lane)
            if f.func == "count":
                out_cols[f.name] = Column(cnt_f, None, INT64)
            else:
                if is_float:
                    lo, hi = frame_lo_hi(f)
                    ps = fl_specs[f.name]
                    at_hi = jnp.take(
                        ps, jnp.clip(hi, 0, n - 1).astype(jnp.int32))
                    lom1 = jnp.maximum(lo - 1, 0).astype(jnp.int32)
                    at_lo = jnp.where(lo > part_start_idx,
                                      jnp.take(ps, lom1), 0.0)
                    sum_f = jnp.where(hi < lo, 0.0, at_hi - at_lo)
                else:
                    sum_f = _frame_lane(f, sum_lane)
                if f.func == "sum":
                    acc_dt = DataType(TypeKind.FLOAT64) if is_float else INT64
                    rdt = (
                        DataType(TypeKind.DECIMAL, True, 18, c.dtype.scale)
                        if c.dtype.is_decimal else acc_dt.with_nullable(True)
                    )
                    out_cols[f.name] = Column(
                        sum_f.astype(rdt.jnp_dtype), cnt_f > 0, rdt
                    )
                else:  # avg
                    from ..expr.functions import _div_round_half_up
                    from ..core.dtypes import Decimal as DecimalT, FLOAT64

                    if c.dtype.is_decimal:
                        rdt = DecimalT(18, c.dtype.scale + 4, nullable=True)
                        num = sum_f * (10 ** 4)
                        d = _div_round_half_up(num, jnp.maximum(cnt_f, 1))
                    else:
                        rdt = FLOAT64.with_nullable(True)
                        d = sum_f / jnp.maximum(cnt_f, 1).astype(jnp.float64)
                    out_cols[f.name] = Column(d.astype(rdt.jnp_dtype), cnt_f > 0, rdt)
        elif f.func in ("sum", "min", "max", "count", "avg"):
            # frame: unbounded preceding .. current row (running aggregates)
            if f.name in run_specs:
                c = sblock[f.arg] if f.arg else None
                run_cnt, run_sum = run_specs[f.name]
                if f.func == "count":
                    out_cols[f.name] = Column(run_cnt, None, INT64)
                elif f.func == "avg":
                    # running AVG = running sum / running valid count
                    # (typed like the framed avg: scale + 4 for
                    # decimals, double otherwise)
                    from ..core.dtypes import FLOAT64
                    from ..core.dtypes import Decimal as DecimalT
                    from ..expr.functions import _div_round_half_up

                    if c.dtype.is_decimal:
                        rdt = DecimalT(18, c.dtype.scale + 4, nullable=True)
                        d = _div_round_half_up(run_sum * (10 ** 4),
                                               jnp.maximum(run_cnt, 1))
                    else:
                        rdt = FLOAT64.with_nullable(True)
                        d = (run_sum
                             / jnp.maximum(run_cnt, 1).astype(jnp.float64))
                    out_cols[f.name] = Column(d.astype(rdt.jnp_dtype),
                                              run_cnt > 0, rdt)
                else:  # running int/decimal sum
                    rdt = (
                        DataType(TypeKind.DECIMAL, True, 18, c.dtype.scale)
                        if c.dtype.is_decimal else INT64.with_nullable(True)
                    )
                    seen = (run_cnt > 0) if c.validity is not None else None
                    out_cols[f.name] = Column(
                        run_sum.astype(rdt.jnp_dtype), seen, rdt, c.dictionary
                    )
            else:
                c = sblock[f.arg]
                acc_dt = (
                    DataType(TypeKind.FLOAT64) if c.dtype.is_float else INT64
                ) if f.func == "sum" else c.dtype
                vals = c.data.astype(acc_dt.jnp_dtype)
                if c.validity is not None:
                    ident = jnp.asarray(0, acc_dt.jnp_dtype) if f.func == "sum" else (
                        jnp.asarray(
                            jnp.iinfo(acc_dt.jnp_dtype).max
                            if f.func == "min" else jnp.iinfo(acc_dt.jnp_dtype).min,
                            acc_dt.jnp_dtype,
                        ) if not acc_dt.is_float else jnp.asarray(
                            jnp.inf if f.func == "min" else -jnp.inf, acc_dt.jnp_dtype
                        )
                    )
                    vals = jnp.where(c.validity, vals, ident)
                data = _segmented_prefix(f.func, vals, part_start)
                # default frame includes PEERS of the current row
                data = jnp.take(data, peer_end_idx.astype(jnp.int32))
                rdt = (
                    DataType(TypeKind.DECIMAL, True, 18, c.dtype.scale)
                    if (f.func == "sum" and c.dtype.is_decimal)
                    else (acc_dt.with_nullable(True) if f.func == "sum" else c.dtype)
                )
                # validity: any non-null seen so far in partition
                if c.validity is not None:
                    seen = jnp.take(
                        _segmented_prefix(
                            "sum", c.validity.astype(jnp.int64),
                            part_start),
                        peer_end_idx.astype(jnp.int32)) > 0
                else:
                    seen = None
                out_cols[f.name] = Column(
                    data.astype(rdt.jnp_dtype), seen, rdt, c.dictionary
                )
        else:
            raise NotImplementedError(f.func)

    return Block.from_dict(out_cols, sel=sel)


__all__ = ["WindowDesc", "window_block"]
