"""Distributed (MPP) query execution: one SPMD program per query.

Role analog: the entire MPP stack L8-L9 of the reference —
``MPPTask`` (``Flash/Mpp/MPPTask.cpp:597``), tunnels, receivers, the
MinTSO admission gate — all of which exists because the reference runs one
C++ process per node exchanging gRPC packets.  On a device mesh none of that
survives contact with the hardware: the whole multi-fragment plan compiles
into ONE ``shard_map``-ped jitted function where exchange edges are
collectives (exchange/shuffle.py) and XLA overlaps them with compute.
There are no task states, no scheduler, no backpressure queues — the
"scheduler" is the XLA async runtime.

What remains host-side (this module): sharding tables onto the mesh,
compiling the SPMD function, re-running with doubled capacities when an
overflow flag comes back (the spill/restore-round analog), and gathering
the result.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ..core.block import Block, Column
from ..exchange.shuffle import allgather_block, shuffle_block
from ..expr.compile import ExprEvaluator
from ..ops import join as J
from ..ops.aggregate import auto_passthrough_aggregate, hash_aggregate
from ..ops.expand import expand_block
from ..ops.sort import limit_block, sort_block, top_n
from ..ops.window import window_block
from ..plan import nodes as P

AXIS = "d"


# ---------------------------------------------------------------------------
# table sharding (the Region-shard analog: rows split across devices)
# ---------------------------------------------------------------------------


def shard_block(block: Block, mesh: Mesh, axis: str = AXIS) -> Block:
    """Pad row count to a multiple of the mesh size and shard axis 0."""
    n_dev = mesh.shape[axis]
    n = block.capacity
    padded = -(-n // n_dev) * n_dev
    pad = padded - n

    sharding = NamedSharding(mesh, PSpec(axis))

    def place(arr, fill=0):
        if pad:
            arr = jnp.concatenate(
                [arr, jnp.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)]
            )
        return jax.device_put(arr, sharding)

    cols = tuple(
        Column(
            place(c.data),
            place(c.validity, False) if c.validity is not None else None,
            c.dtype,
            c.dictionary,
        )
        for c in block.columns
    )
    sel = place(block.sel_mask(), False)
    return Block(names=block.names, columns=cols, sel=sel)


def shard_catalog_blocks(blocks: Dict[str, Block], mesh: Mesh, axis: str = AXIS) -> Dict[str, Block]:
    return {k: shard_block(b, mesh, axis) for k, b in blocks.items()}


# ---------------------------------------------------------------------------
# SPMD execution (runs inside shard_map; blocks are per-device shards)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExchangeConfig:
    """Static capacities for exchange outputs (bounded-output contract).
    Keyed by the stable DFS node counter (see plan enumeration in
    runtime/executor.py); missing entries use defaults.  ``factors`` holds
    per-exchange multipliers the retry loop doubles on overflow."""

    shuffle_factor: float = 2.0         # out_capacity = factor * local capacity
    capacities: Dict[int, int] = dataclasses.field(default_factory=dict)
    factors: Dict[int, float] = dataclasses.field(default_factory=dict)
    # transient per-trace store of published runtime filters
    # rf_id -> list of (min, max, sorted_keys|None) per build key column
    rf_values: Dict[str, list] = dataclasses.field(default_factory=dict)
    # IN-set filters are published only for build sides at most this big
    # (the reference gates IN filters by build NDV the same way,
    # ``DataStreams/RuntimeFilter.h:32`` rs_operator IN type)
    rf_in_set_max_build: int = 1 << 20


def _publish_runtime_filter(node: P.Join, build: Block, rf_values: Dict[str, list],
                            axis: Optional[str], in_set_max: int = 1 << 20):
    """min/max — plus, for small builds, a sorted key set — of each
    (numeric) build key column over live+valid rows, reduced/gathered
    across the mesh when running SPMD.

    The IN form is the device answer to the reference's IN-set runtime
    filter (``DataStreams/RuntimeFilter.h:32``): instead of a host hash
    set, the live build keys are kept as a sorted array (dead rows at
    +inf) and membership at apply time is two sort-method searchsorteds —
    a semi-join in exchange for shuffle volume."""
    from ..runtime.metrics import METRICS

    METRICS.counter("runtime_filters_published_total").inc()
    live = build.sel_mask()
    entries = []
    for kn in node.build_keys:
        c = build[kn]
        if c.dtype.is_string or c.dtype.is_float:
            entries.append(None)  # unsupported column type: no filter
            continue
        ok = live if c.validity is None else (live & c.validity)
        data = c.data.astype(jnp.int64)
        big = jnp.int64(2**62)
        mn = jnp.min(jnp.where(ok, data, big))
        mx = jnp.max(jnp.where(ok, data, -big))
        if axis is not None:
            mn = jax.lax.pmin(mn, axis)
            mx = jax.lax.pmax(mx, axis)
        key_set = None
        if build.capacity <= in_set_max:
            local = jnp.where(ok, data, big)
            if axis is not None:
                # global membership set: gather every shard's keys
                local = jax.lax.all_gather(local, axis).reshape(-1)
            key_set = jax.lax.sort(local)
        entries.append((mn, mx, key_set))
    rf_values[node.rf_id] = entries


def _apply_runtime_filter(node: P.RuntimeFilterApply, child: Block,
                          rf_values: Dict[str, list]) -> Block:
    rf = rf_values.get(node.rf_id)
    if rf is None:
        return child  # filter not built yet — degrade to no-op (rf timeout analog)
    sel = child.sel_mask()
    for kn, entry in zip(node.key_names, rf):
        if entry is None:
            continue
        mn, mx, key_set = entry
        c = child[kn]
        data = c.data.astype(jnp.int64)
        keep = (data >= mn) & (data <= mx)
        if key_set is not None:
            lo = jnp.searchsorted(key_set, data, side="left", method="sort")
            hi = jnp.searchsorted(key_set, data, side="right", method="sort")
            keep = keep & (hi > lo)
        if c.validity is not None:
            keep = keep & c.validity
        sel = sel & keep
    return child.with_sel(sel)


def _drain_spmd_errors(ev: ExprEvaluator, block: Block,
                       overflows: Dict[str, jnp.ndarray]) -> None:
    """Runtime error channel, SPMD flavor: per-row EvalError lanes fold
    into scalar flags keyed ``__rterr__<message>`` in the flag dict —
    the per-device flags ride the existing pmax reduction
    (compile_distributed) and the executor's split_runtime_errors
    raises host-side (plan/compiler.py:_drain_eval_errors is the
    single-fragment twin)."""
    from ..runtime.errors import RTERR_PREFIX

    for mask, msg in ev.runtime_errors:
        if block.sel is not None:
            mask = mask & block.sel
        flag = jnp.any(mask)
        key = RTERR_PREFIX + msg
        prev = overflows.get(key)
        overflows[key] = flag if prev is None else (prev | flag)
    ev.runtime_errors.clear()


def _exec_spmd(
    node: P.PlanNode,
    tables: Dict[str, Block],
    axis: str,
    cfg: ExchangeConfig,
    overflows: Dict[str, jnp.ndarray],
    ctr: List[int],
) -> Block:
    # per-operator profiler scopes (see plan/compiler._exec)
    with jax.named_scope(type(node).__name__):
        return _exec_spmd_node(node, tables, axis, cfg, overflows, ctr)


def _exec_spmd_node(
    node: P.PlanNode,
    tables: Dict[str, Block],
    axis: str,
    cfg: ExchangeConfig,
    overflows: Dict[str, jnp.ndarray],
    ctr: List[int],
) -> Block:
    ctr[0] += 1
    nid = f"{type(node).__name__}_{ctr[0]}"

    if isinstance(node, P.TableScan):
        block = tables[node.table]
        if node.columns is not None:
            block = block.select(list(node.columns))
        return block

    if isinstance(node, P.Selection):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        ev = ExprEvaluator(child)
        cond = ev.evaluate(node.cond)
        _drain_spmd_errors(ev, child, overflows)
        mask = cond.data.astype(jnp.bool_)
        if cond.validity is not None:
            mask = mask & cond.validity
        return child.and_sel(mask)

    if isinstance(node, P.AddColumns):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        ev = ExprEvaluator(child)
        out = child
        for name, e in node.exprs.items():
            out = out.with_column(name, ev.evaluate(e))
        _drain_spmd_errors(ev, child, overflows)
        return out

    if isinstance(node, P.Projection):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        ev = ExprEvaluator(child)
        out = Block.from_dict(
            {name: ev.evaluate(e) for name, e in node.exprs.items()}, sel=child.sel
        )
        _drain_spmd_errors(ev, child, overflows)
        return out

    if isinstance(node, P.Aggregation):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        if node.mode == "auto":
            res = auto_passthrough_aggregate(child, list(node.keys), list(node.aggs))
        else:
            res = hash_aggregate(child, list(node.keys), list(node.aggs), node.num_slots)
        overflows[nid] = res.overflow
        return res.block

    if isinstance(node, P.Expand):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return expand_block(child, [list(s) for s in node.grouping_sets], node.gid_name)

    if isinstance(node, P.CrossJoin):
        probe = _exec_spmd(node.probe, tables, axis, cfg, overflows, ctr)
        build = _exec_spmd(node.build, tables, axis, cfg, overflows, ctr)
        cap = node.output_capacity or probe.capacity
        out, needed = J.cross_join(probe, build, cap)
        overflows[nid] = needed
        return out

    if isinstance(node, P.Join):
        if node.rf_id is not None:
            # build first so its min/max filter reaches the probe subtree
            build = _exec_spmd(node.build, tables, axis, cfg, overflows, ctr)
            _publish_runtime_filter(node, build, cfg.rf_values, axis,
                                    cfg.rf_in_set_max_build)
            probe = _exec_spmd(node.probe, tables, axis, cfg, overflows, ctr)
        else:
            probe = _exec_spmd(node.probe, tables, axis, cfg, overflows, ctr)
            build = _exec_spmd(node.build, tables, axis, cfg, overflows, ctr)
        cap = None if node.unique_build else (node.output_capacity or probe.capacity)
        joined, extras = J.hash_join_with_tail(
            probe, build, list(node.probe_keys), list(node.build_keys),
            kind=node.kind, output_capacity=cap,
        )
        overflows[nid] = extras["overflow"]
        return joined

    if isinstance(node, P.RuntimeFilterApply):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return _apply_runtime_filter(node, child, cfg.rf_values)

    if isinstance(node, P.SkewShuffleJoin):
        from ..exchange.skew import skew_shuffle_join

        probe = _exec_spmd(node.probe, tables, axis, cfg, overflows, ctr)
        build = _exec_spmd(node.build, tables, axis, cfg, overflows, ctr)
        ctr[0] += 1
        xid = ctr[0]
        shuffle_cap = cfg.capacities.get(
            xid, int(np.ceil(probe.capacity * cfg.factors.get(xid, cfg.shuffle_factor)))
        )
        ctr[0] += 1
        bxid = ctr[0]
        bshuffle_cap = cfg.capacities.get(
            bxid, int(np.ceil(build.capacity * cfg.factors.get(bxid, cfg.shuffle_factor)))
        )
        out, ovs = skew_shuffle_join(
            probe, build, list(node.probe_keys), list(node.build_keys),
            node.kind, axis, shuffle_cap, bshuffle_cap,
            node.output_capacity or probe.capacity, hot_k=node.hot_k,
            sample_per_device=getattr(node, "sample_per_device", 2048),
        )
        overflows[f"Exchange_{xid}"] = ovs["skew_probe_shuffle"]
        overflows[f"Exchange_{bxid}"] = ovs["skew_build_shuffle"]
        overflows[nid] = jnp.maximum(
            ovs["skew_cold_join"], ovs["skew_hot_join"]
        )
        return out

    if isinstance(node, P.TopN):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return top_n(child, list(node.sort_keys), node.limit)

    if isinstance(node, P.Sort):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return sort_block(child, list(node.sort_keys))

    if isinstance(node, P.Limit):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return limit_block(child, node.limit)

    if isinstance(node, P.Window):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return window_block(
            child, list(node.partition_by), list(node.order_by), list(node.funcs)
        )

    if isinstance(node, P.LanedWindow):
        child = _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)
        return _laned_window(child, node, axis)

    if isinstance(node, P.Union):
        from ..exchange.skew import concat_blocks

        parts = [_exec_spmd(c, tables, axis, cfg, overflows, ctr) for c in node.children]
        out = parts[0]
        for p in parts[1:]:
            out = concat_blocks(out, p)
        return out

    if isinstance(node, P.WithCTE):
        tables = dict(tables)
        for name, d in node.defs.items():
            tables["__cte_" + name] = _exec_spmd(d, tables, axis, cfg, overflows, ctr)
        return _exec_spmd(node.child, tables, axis, cfg, overflows, ctr)

    if isinstance(node, P.CTERef):
        return tables["__cte_" + node.name]

    if isinstance(node, P.ExchangeReceiver):
        sender = node.source
        assert isinstance(sender, P.ExchangeSender), "receiver must wrap a sender"
        ctr[0] += 1
        xid = ctr[0]
        child = _exec_spmd(sender.child, tables, axis, cfg, overflows, ctr)
        if sender.exchange_type == "hash":
            factor = cfg.factors.get(xid, cfg.shuffle_factor)
            cap = cfg.capacities.get(xid, int(np.ceil(child.capacity * factor)))
            out, ov = shuffle_block(child, list(sender.keys), axis, cap)
            overflows[f"Exchange_{xid}"] = ov
            return out
        if sender.exchange_type in ("broadcast", "passthrough"):
            return allgather_block(child, axis)
        raise NotImplementedError(sender.exchange_type)

    raise NotImplementedError(type(node).__name__)


def plan_distribution(node: P.PlanNode) -> str:
    """Static row-distribution of a plan's output: 'sharded' (each device
    holds distinct rows) or 'replicated' (every device holds all rows —
    after a broadcast/passthrough exchange)."""
    if isinstance(node, (P.TableScan, P.CTERef)):
        return "sharded"
    if isinstance(node, P.WithCTE):
        return plan_distribution(node.child)
    if isinstance(node, P.ExchangeReceiver):
        sender = node.source
        assert isinstance(sender, P.ExchangeSender)
        if sender.exchange_type in ("broadcast", "passthrough"):
            return "replicated"
        return "sharded"
    if isinstance(node, P.Join):
        return plan_distribution(node.probe)
    return plan_distribution(node.children[0])


def compile_distributed(
    plan: P.PlanNode,
    mesh: Mesh,
    axis: str = AXIS,
    cfg: Optional[ExchangeConfig] = None,
) -> Callable[[Dict[str, Block]], Tuple[Block, Dict[str, jnp.ndarray]]]:
    """Compile the whole plan (with exchange nodes) into one jitted SPMD
    function over ``mesh``.  Input tables must be sharded with
    ``shard_catalog_blocks``; the result block comes back row-sharded on
    ``axis`` (or replicated after a gather) — use ``collect_result``."""
    cfg = cfg or ExchangeConfig()

    def spmd_fn(tables: Dict[str, Block]):
        overflows: Dict[str, jnp.ndarray] = {}
        cfg.rf_values.clear()  # traced values must not leak across traces
        out = _exec_spmd(plan, tables, axis, cfg, overflows, [0])
        # reduce required-capacity flags across devices (max requirement)
        overflows = {
            k: jax.lax.pmax(v.astype(jnp.int64), axis) for k, v in overflows.items()
        }
        return out, overflows

    out_rows_spec = PSpec(axis) if plan_distribution(plan) == "sharded" else PSpec()
    shard_fn = jax.shard_map(
        spmd_fn,
        mesh=mesh,
        in_specs=(PSpec(axis),),
        out_specs=(out_rows_spec, PSpec()),
        check_vma=False,
    )
    return jax.jit(shard_fn)



def _laned_window(child: Block, node, axis: str) -> Block:
    """Lane-split window stitching (see plan/nodes.LanedWindow): local
    windows per (partition, lane), then a psum'd (part_cap x lanes) carry
    table offsets ranks and adds carry-ins to running aggregates.  Lane
    ids bucket the ORDER-KEY VALUE, so peers never straddle lanes and
    rank ties stay exact."""
    import dataclasses as _dc

    from ..ops.window import window_block

    L = int(node.n_lanes)
    Pcap = int(node.part_cap)
    G = Pcap * L
    # running AVG splits into sum+count temps: each gets its own lane
    # carry, then the adjusted quotient is retyped like the local avg
    work_funcs = []
    avg_specs = {}
    pr_specs = {}     # percent_rank -> local rank temp
    cd_specs = {}     # cume_dist   -> local cume_dist temp
    nt_specs = {}     # ntile       -> (local row_number temp, k)
    lead_specs = {}   # lead/lag    -> original desc (local runs w/o default)
    head_specs = {}   # first/nth   -> (kind, desc, cume-temp or None)
    frame_specs = {}  # bounded-ROWS aggs -> (desc, local valid-count temp)
    favg_specs = {}   # framed avg  -> (sum temp, count temp, desc)
    for f in node.funcs:
        if f.func == "avg" and f.frame is None:
            s, c2 = f.name + "__ls", f.name + "__lc"
            work_funcs += [_dc.replace(f, func="sum", name=s),
                           _dc.replace(f, func="count", name=c2)]
            avg_specs[f.name] = (s, c2, f)
        elif f.func == "avg":
            # framed avg = framed sum / framed valid count, each lane-
            # stitched through the boundary tables below
            s, c2 = f.name + "__fs", f.name + "__fc"
            work_funcs += [_dc.replace(f, func="sum", name=s),
                           _dc.replace(f, func="count", name=c2)]
            frame_specs[s] = (_dc.replace(f, func="sum", name=s), c2)
            favg_specs[f.name] = (s, c2, f)
        elif f.func == "percent_rank":
            t = f.name + "__lr"
            work_funcs.append(_dc.replace(f, func="rank", name=t,
                                          arg=None, frame=None))
            pr_specs[f.name] = t
        elif f.func == "cume_dist":
            t = f.name + "__lcd"
            work_funcs.append(_dc.replace(f, func="cume_dist", name=t,
                                          arg=None, frame=None))
            cd_specs[f.name] = t
        elif f.func == "ntile":
            t = f.name + "__lrn"
            work_funcs.append(_dc.replace(f, func="row_number", name=t,
                                          arg=None, frame=None))
            nt_specs[f.name] = (t, max(int(f.offset), 1))
        elif f.func in ("lead", "lag"):
            # the local window must NOT apply the default at lane edges
            # (those are stitched from neighbor lanes); the TRUE
            # partition edge applies it below
            work_funcs.append(_dc.replace(f, default=None))
            lead_specs[f.name] = f
        elif f.func == "first_value":
            head_specs[f.name] = ("first", f, None)
        elif f.func == "nth_value":
            t = f.name + "__lcd"
            work_funcs.append(_dc.replace(f, func="cume_dist", name=t,
                                          arg=None, frame=None,
                                          offset=1))
            head_specs[f.name] = ("nth", f, t)
        elif f.func in ("sum", "count", "min", "max") \
                and f.frame is not None:
            c2 = f.name + "__fc"
            work_funcs.append(f)
            work_funcs.append(_dc.replace(f, func="count", name=c2))
            frame_specs[f.name] = (f, c2)
        else:
            work_funcs.append(f)
    local = window_block(child, list(node.partition_by) + [node.lane_col],
                         list(node.order_by), work_funcs)
    n = local.capacity
    live = local.sel_mask()

    # exact partition slot (first key most significant — matches the
    # window's lexicographic sort, so gids come out SORTED and the
    # segment reductions avoid the unsorted-scatter cliff)
    spans = []
    slots = []
    for name, spec in zip(node.partition_by, node.part_specs):
        c = local[name]
        if spec[0] == "dict":
            span = int(spec[1])
            s = c.data.astype(jnp.int64)
        else:
            lo, span = int(spec[1]), int(spec[2])
            s = c.data.astype(jnp.int64) - lo
        if c.validity is not None:
            s = jnp.where(c.validity, s, span)  # NULL partition sorts last
            span += 1
        slots.append(jnp.clip(s, 0, span - 1))
        spans.append(span)
    pslot = jnp.zeros(n, dtype=jnp.int64)
    for s, span in zip(slots, spans):
        pslot = pslot * span + s
    lane = jnp.clip(local[node.lane_col].data.astype(jnp.int64), 0, L - 1)
    gid = jnp.where(live, pslot * L + lane, G).astype(jnp.int32)

    def seg_sum(vals):
        return jax.ops.segment_sum(vals, gid, num_segments=G + 1,
                                   indices_are_sorted=True)[:G]

    def seg_max(vals):
        # empty segments yield the dtype min; clamp to 0 (every real
        # per-lane maximum here is >= 1, and each (partition, lane)
        # group lives on exactly one device after the exchange)
        return jnp.maximum(
            jax.ops.segment_max(vals, gid, num_segments=G + 1,
                                indices_are_sorted=True)[:G], 0)

    def carry_of(totals):
        """psum across devices, then EXCLUSIVE prefix along lanes."""
        t = jax.lax.psum(totals, axis)
        t2 = t.reshape(Pcap, L)
        exc = jnp.concatenate(
            [jnp.zeros((Pcap, 1), t.dtype),
             jnp.cumsum(t2, axis=1)[:, :-1]], axis=1)
        return exc.reshape(G)

    def per_row(carry_vec):
        return jnp.take(carry_vec, jnp.minimum(gid, G - 1))

    counts = seg_sum(live.astype(jnp.int64))
    cnt_carry = per_row(carry_of(counts))

    def carry_minmax(vals_masked, is_min):
        """Per-(p,lane) extreme -> cross-device combine -> EXCLUSIVE
        prefix along lanes (identity at lane 0)."""
        ident = (jnp.iinfo(jnp.int64).max if is_min
                 else jnp.iinfo(jnp.int64).min)
        seg = (jax.ops.segment_min if is_min else jax.ops.segment_max)(
            vals_masked, gid, num_segments=G + 1,
            indices_are_sorted=True)[:G]
        t = (jax.lax.pmin if is_min else jax.lax.pmax)(seg, axis)
        t2 = t.reshape(Pcap, L)
        cum = (jax.lax.cummin if is_min else jax.lax.cummax)(t2, axis=1)
        exc = jnp.concatenate(
            [jnp.full((Pcap, 1), ident, dtype=t.dtype), cum[:, :-1]],
            axis=1)
        return exc.reshape(G), ident

    handled_later = set(frame_specs) | {c for _, c in frame_specs.values()}
    for _k, (_t, _n) in nt_specs.items():
        handled_later.add(_t)
    handled_later |= set(pr_specs.values()) | set(cd_specs.values())
    handled_later |= {t for _, _, t in head_specs.values()
                      if t is not None}
    out = local
    for f in work_funcs:
        if f.name in handled_later or f.name in lead_specs:
            continue
        c = local[f.name]
        if f.func in ("row_number", "rank"):
            adj = c.data + jnp.where(live, cnt_carry, 0)
            out = out.with_column(f.name, Column(adj, c.validity, c.dtype))
        elif f.func == "dense_rank":
            dmax = seg_max(jnp.where(live, c.data, 0))
            adj = c.data + jnp.where(live, per_row(carry_of(dmax)), 0)
            out = out.with_column(f.name, Column(adj, c.validity, c.dtype))
        elif f.func in ("sum", "count"):
            a = local[f.arg]
            valid = a.valid_mask() & live
            vcnt_carry = per_row(carry_of(seg_sum(valid.astype(jnp.int64))))
            if f.func == "count":
                adj = c.data + jnp.where(live, vcnt_carry, 0)
                out = out.with_column(f.name,
                                      Column(adj, c.validity, c.dtype))
            else:
                tot = seg_sum(jnp.where(valid, a.data.astype(jnp.int64), 0))
                adj = c.data + jnp.where(live, per_row(carry_of(tot)), 0)
                validity = None
                if c.validity is not None:
                    validity = c.validity | (vcnt_carry > 0)
                out = out.with_column(f.name, Column(adj, validity, c.dtype))
        elif f.func in ("min", "max"):
            a = local[f.arg]
            valid = a.valid_mask() & live
            vcnt_carry = per_row(carry_of(seg_sum(valid.astype(jnp.int64))))
            is_min = f.func == "min"
            ident0 = (jnp.iinfo(jnp.int64).max if is_min
                      else jnp.iinfo(jnp.int64).min)
            masked = jnp.where(valid, a.data.astype(jnp.int64), ident0)
            carry_tab, ident = carry_minmax(masked, is_min)
            carry = per_row(carry_tab)
            has_carry = vcnt_carry > 0
            local_valid = c.validity if c.validity is not None else live
            base = jnp.where(local_valid, c.data.astype(jnp.int64), ident)
            cval = jnp.where(has_carry, carry, ident)
            merged = (jnp.minimum if is_min else jnp.maximum)(base, cval)
            new_valid = (local_valid | has_carry) & live
            out = out.with_column(
                f.name, Column(merged.astype(c.data.dtype), new_valid,
                               c.dtype, c.dictionary))
        elif f.func == "last_value":
            # peers never straddle value-bucketed lanes: the lane-local
            # last peer IS the partition-global one
            pass
        else:  # planner guarantees this never happens
            raise NotImplementedError(f"laned window func {f.func}")
    # ---- extended family: global positions + boundary tables --------
    # (fine-grained shuffle at FULL breadth, VERDICT r4 item 3: lead/
    # lag/first/nth via per-lane head/tail row tables exchanged with
    # psum; ntile/percent_rank/cume_dist via partition totals; bounded
    # ROWS frames via suffix/prefix/full-lane region tables.  Reference:
    # Flash/Mpp/FineGrainedShuffleWriter.cpp + the window family it
    # serves.)
    if (pr_specs or cd_specs or nt_specs or lead_specs or head_specs
            or frame_specs):
        from ..ops.segments import forward_fill_positions

        H = max(1, int(getattr(node, "boundary_depth", 1)))
        newseg = gid != jnp.roll(gid, 1)
        newseg = newseg.at[0].set(True)
        seg_start_idx = forward_fill_positions(newseg).astype(jnp.int64)
        pos = jnp.arange(n, dtype=jnp.int64) - seg_start_idx
        cntG = jax.lax.psum(counts, axis)
        cnt2 = cntG.reshape(Pcap, L)
        carry2 = jnp.cumsum(cnt2, axis=1) - cnt2  # exclusive lane start
        tot_tab = cnt2.sum(axis=1)
        pslot_c = jnp.minimum(pslot, Pcap - 1)
        tot_row = jnp.take(tot_tab, pslot_c)
        g_row = cnt_carry + pos
        cnt_local_row = jnp.take(counts, jnp.minimum(gid, G - 1))
        GH = G * H
        _tables: dict = {}

        def arg_tables(name):
            """psum'd (G, H) head/tail row tables + full-lane aggregates
            for one argument column — each (partition, lane) lives on
            exactly one device after the exchange, so psum IS the
            all-gather of owned entries."""
            if name in _tables:
                return _tables[name]
            a = local[name]
            isf = a.dtype.is_float
            vals = a.data.astype(jnp.float64 if isf else jnp.int64)
            av = a.valid_mask() & live
            zero = jnp.asarray(0, vals.dtype)
            mvals = jnp.where(av, vals, zero)
            hs = jnp.where(live & (pos < H), gid * H + pos,
                           GH).astype(jnp.int32)
            tpos = H - cnt_local_row + pos
            ts = jnp.where(live & (tpos >= 0), gid * H + tpos,
                           GH).astype(jnp.int32)

            def seg(v, slot):
                return jax.ops.segment_sum(
                    v, slot, num_segments=GH + 1,
                    indices_are_sorted=True)[:GH]

            head_v = jax.lax.psum(seg(mvals, hs), axis)
            head_ok = jax.lax.psum(seg(av.astype(jnp.int64), hs), axis)
            tail_v = jax.lax.psum(seg(mvals, ts), axis)
            tail_ok = jax.lax.psum(seg(av.astype(jnp.int64), ts), axis)
            lane_sum = jax.lax.psum(seg_sum(mvals), axis)
            lane_vcnt = jax.lax.psum(
                seg_sum(av.astype(jnp.int64)), axis)
            big = (jnp.inf if isf else jnp.iinfo(jnp.int64).max)
            small = (-jnp.inf if isf else jnp.iinfo(jnp.int64).min)
            mn = jnp.where(av, vals, jnp.asarray(big, vals.dtype))
            mx = jnp.where(av, vals, jnp.asarray(small, vals.dtype))
            lane_min = jax.lax.pmin(jax.ops.segment_min(
                mn, gid, num_segments=G + 1,
                indices_are_sorted=True)[:G], axis)
            lane_max = jax.lax.pmax(jax.ops.segment_max(
                mx, gid, num_segments=G + 1,
                indices_are_sorted=True)[:G], axis)
            t = {"head_v": head_v, "head_ok": head_ok, "tail_v": tail_v,
                 "tail_ok": tail_ok, "lane_sum": lane_sum,
                 "lane_vcnt": lane_vcnt, "lane_min": lane_min,
                 "lane_max": lane_max, "isf": isf,
                 "big": big, "small": small}
            # prefix/suffix region tables: head_pre*[k] aggregates the
            # FIRST k rows of the lane, tail_suf*[k] the LAST k (k<=H)
            hv2 = head_v.reshape(G, H)
            ho2 = head_ok.reshape(G, H)
            tv2 = tail_v.reshape(G, H)
            to2 = tail_ok.reshape(G, H)
            zcol = jnp.zeros((G, 1), hv2.dtype)
            zicol = jnp.zeros((G, 1), jnp.int64)
            t["head_presum"] = jnp.concatenate(
                [zcol, jnp.cumsum(hv2, axis=1)], axis=1).reshape(-1)
            t["head_precnt"] = jnp.concatenate(
                [zicol, jnp.cumsum(ho2, axis=1)], axis=1).reshape(-1)
            t["tail_sufsum"] = jnp.concatenate(
                [zcol, jnp.cumsum(tv2[:, ::-1], axis=1)],
                axis=1).reshape(-1)
            t["tail_sufcnt"] = jnp.concatenate(
                [zicol, jnp.cumsum(to2[:, ::-1], axis=1)],
                axis=1).reshape(-1)
            # min/max prefix (head) and suffix (tail) — masked by ok
            bigc = jnp.asarray(big, hv2.dtype)
            smallc = jnp.asarray(small, hv2.dtype)
            hmn = jnp.where(ho2 > 0, hv2, bigc)
            hmx = jnp.where(ho2 > 0, hv2, smallc)
            tmn = jnp.where(to2 > 0, tv2, bigc)
            tmx = jnp.where(to2 > 0, tv2, smallc)
            t["head_premin"] = jnp.concatenate(
                [jnp.full((G, 1), bigc), jax.lax.cummin(hmn, axis=1)],
                axis=1).reshape(-1)
            t["head_premax"] = jnp.concatenate(
                [jnp.full((G, 1), smallc), jax.lax.cummax(hmx, axis=1)],
                axis=1).reshape(-1)
            t["tail_sufmin"] = jnp.concatenate(
                [jnp.full((G, 1), bigc),
                 jax.lax.cummin(tmn[:, ::-1], axis=1)],
                axis=1).reshape(-1)
            t["tail_sufmax"] = jnp.concatenate(
                [jnp.full((G, 1), smallc),
                 jax.lax.cummax(tmx[:, ::-1], axis=1)],
                axis=1).reshape(-1)
            _tables[name] = t
            return t

        lane_row = lane  # per-row lane id (int64)
        cnt2f = cnt2.reshape(-1)
        carry2f = carry2.reshape(-1)

        def row_at(name, q, from_tail):
            """(value, valid, exists) at partition-global index q;
            exact when q lands within H rows of its lane's head (or
            tail) — the callers' deficits guarantee that."""
            t = arg_tables(name)
            src_v = t["tail_v"] if from_tail else t["head_v"]
            src_o = t["tail_ok"] if from_tail else t["head_ok"]
            val = jnp.zeros(n, dtype=src_v.dtype)
            okv = jnp.zeros(n, dtype=bool)
            ex = jnp.zeros(n, dtype=bool)
            for m in range(L):
                gi = pslot_c * L + m
                base = jnp.take(carry2f, gi)
                cm = jnp.take(cnt2f, gi)
                within = (q >= base) & (q < base + cm)
                if from_tail:
                    off = jnp.clip(H - cm + (q - base), 0, H - 1)
                else:
                    off = jnp.clip(q - base, 0, H - 1)
                idx = jnp.minimum(gi * H + off, GH - 1)
                val = jnp.where(within, jnp.take(src_v, idx), val)
                okv = jnp.where(within, jnp.take(src_o, idx) > 0, okv)
                ex = ex | within
            return val, okv, ex

        def region(name, f_lo, f_hi, before, want):
            """Aggregate over the OUT-OF-LANE part of the frame
            [f_lo, f_hi] (global indices): the suffix of a partial lane
            plus any fully-covered lanes between it and the current
            one.  want in {sum, vcnt, min, max}."""
            t = arg_tables(name)
            if want == "sum":
                ident = jnp.asarray(0, t["lane_sum"].dtype)
                full_tab, pre, suf = (t["lane_sum"], t["head_presum"],
                                      t["tail_sufsum"])
            elif want == "vcnt":
                ident = jnp.int64(0)
                full_tab, pre, suf = (t["lane_vcnt"], t["head_precnt"],
                                      t["tail_sufcnt"])
            elif want == "min":
                ident = jnp.asarray(t["big"], t["lane_min"].dtype)
                full_tab, pre, suf = (t["lane_min"], t["head_premin"],
                                      t["tail_sufmin"])
            else:
                ident = jnp.asarray(t["small"], t["lane_max"].dtype)
                full_tab, pre, suf = (t["lane_max"], t["head_premax"],
                                      t["tail_sufmax"])

            def comb(a, b):
                if want in ("sum", "vcnt"):
                    return a + b
                return jnp.minimum(a, b) if want == "min" \
                    else jnp.maximum(a, b)

            acc = jnp.full(n, ident)
            for m in range(L):
                gi = pslot_c * L + m
                base = jnp.take(carry2f, gi)
                cm = jnp.take(cnt2f, gi)
                lane_end = base + cm - 1
                side = (lane_row > m) if before else (lane_row < m)
                ov_lo = jnp.maximum(f_lo, base)
                ov_hi = jnp.minimum(f_hi, lane_end)
                any_ = side & (cm > 0) & (ov_lo <= ov_hi)
                fullc = (ov_lo <= base) & (ov_hi >= lane_end)
                if before:
                    # partial overlap is a SUFFIX of lane m
                    k = jnp.clip(lane_end - ov_lo + 1, 0, H)
                    part = jnp.take(suf, jnp.minimum(
                        gi * (H + 1) + k, G * (H + 1) - 1))
                else:
                    # partial overlap is a PREFIX of lane m
                    k = jnp.clip(ov_hi - base + 1, 0, H)
                    part = jnp.take(pre, jnp.minimum(
                        gi * (H + 1) + k, G * (H + 1) - 1))
                c = jnp.where(fullc, jnp.take(full_tab, gi), part)
                acc = comb(acc, jnp.where(any_, c, ident))
            return acc

        # percent_rank / cume_dist / ntile (partition totals)
        from ..core.dtypes import FLOAT64 as _F64

        for name, tmp in pr_specs.items():
            r_adj = (local[tmp].data.astype(jnp.int64)
                     + jnp.where(live, cnt_carry, 0))
            denom = jnp.maximum(tot_row - 1, 1).astype(jnp.float64)
            out = out.with_column(name, Column(
                (r_adj - 1).astype(jnp.float64) / denom, None, _F64))
        for name, tmp in cd_specs.items():
            cdl = local[tmp].data.astype(jnp.float64)
            le_local = jnp.round(
                cdl * cnt_local_row.astype(jnp.float64))
            le = le_local + jnp.where(live, cnt_carry, 0).astype(
                jnp.float64)
            out = out.with_column(name, Column(
                le / jnp.maximum(tot_row, 1).astype(jnp.float64),
                None, _F64))
        for name, (tmp, k) in nt_specs.items():
            rn0 = (local[tmp].data.astype(jnp.int64)
                   + jnp.where(live, cnt_carry, 0) - 1)
            kk = jnp.int64(k)
            q_ = tot_row // kk
            r_ = tot_row % kk
            bigrows = (q_ + 1) * r_
            bucket = jnp.where(
                rn0 < bigrows,
                rn0 // jnp.maximum(q_ + 1, 1),
                jnp.where(q_ > 0,
                          r_ + (rn0 - bigrows) // jnp.maximum(q_, 1),
                          rn0))
            from ..core.dtypes import INT64 as _I64N
            out = out.with_column(name, Column(bucket + 1, None, _I64N))

        # lead / lag boundary stitching
        for name, f in lead_specs.items():
            c = local[name]
            a = local[f.arg]
            off = jnp.int64(f.offset)
            if f.func == "lead":
                in_lane = pos + off < cnt_local_row
                q = g_row + off
                beyond = q >= tot_row
                v, ok, ex = row_at(f.arg, q, from_tail=False)
            else:
                in_lane = pos >= off
                q = g_row - off
                beyond = q < 0
                v, ok, ex = row_at(f.arg, q, from_tail=True)
            base_d = c.data
            lv = c.validity if c.validity is not None \
                else jnp.ones(n, dtype=bool)
            stitched = jnp.where(in_lane, base_d,
                                 v.astype(base_d.dtype))
            svalid = jnp.where(in_lane, lv, ok & ex & ~beyond)
            if f.default is not None and not a.dtype.is_string:
                dflt = jnp.asarray(f.default, dtype=base_d.dtype)
                use_d = (~in_lane) & beyond
                stitched = jnp.where(use_d, dflt, stitched)
                svalid = svalid | use_d
            out = out.with_column(name, Column(
                stitched, svalid & live, a.dtype.with_nullable(True),
                a.dictionary))

        # first_value / nth_value via partition head rows
        for name, (kind, f, cume_tmp) in head_specs.items():
            a = local[f.arg]
            q = (jnp.zeros(n, dtype=jnp.int64) if kind == "first"
                 else jnp.full(n, jnp.int64(max(int(f.offset), 1) - 1)))
            v, ok, ex = row_at(f.arg, q, from_tail=False)
            valid = ok & ex & live
            if kind == "nth":
                cdl = local[cume_tmp].data.astype(jnp.float64)
                le = (jnp.round(cdl * cnt_local_row.astype(jnp.float64))
                      + jnp.where(live, cnt_carry, 0).astype(
                          jnp.float64))
                # default frame start..current-peers: the n-th row must
                # already be inside it
                valid = valid & (le - 1 >= q.astype(jnp.float64))
            dt_out = a.dtype.with_nullable(kind == "nth"
                                           or a.dtype.nullable)
            ref = local[f.arg].data
            out = out.with_column(name, Column(
                v.astype(ref.dtype), valid, dt_out, a.dictionary))

        # bounded ROWS frames: local in-lane slice + out-of-lane regions
        for name, (f, cnt_tmp) in frame_specs.items():
            prec, foll = f.frame
            a = local[f.arg] if f.arg else None
            f_lo = jnp.maximum(g_row - jnp.int64(prec), 0)
            f_hi = jnp.minimum(g_row + jnp.int64(foll), tot_row - 1)
            argn = f.arg
            c = local[name]
            if argn is None:
                # COUNT(*) over the frame needs no tables: the frame is
                # a contiguous global row range
                gcnt = f_hi - f_lo + 1
                out = out.with_column(name, Column(gcnt, None, c.dtype))
                continue
            vb = region(argn, f_lo, f_hi, True, "vcnt")
            va = region(argn, f_lo, f_hi, False, "vcnt")
            local_cnt = local[cnt_tmp].data.astype(jnp.int64)
            gcnt = local_cnt + vb + va
            if f.func == "count":
                out = out.with_column(name, Column(
                    gcnt, None, c.dtype))
                continue
            if f.func in ("min", "max"):
                want = f.func
                t = arg_tables(argn)
                ident = jnp.asarray(
                    t["big"] if want == "min" else t["small"],
                    t["lane_min"].dtype)
                rb = region(argn, f_lo, f_hi, True, want)
                ra = region(argn, f_lo, f_hi, False, want)
                lv = c.validity if c.validity is not None \
                    else (local_cnt > 0)
                base = jnp.where(lv, c.data.astype(ident.dtype), ident)
                red = (jnp.minimum if want == "min" else jnp.maximum)
                merged = red(red(base, rb), ra)
                out = out.with_column(name, Column(
                    merged.astype(c.data.dtype), (gcnt > 0) & live,
                    c.dtype.with_nullable(True), c.dictionary))
                continue
            # framed SUM (also the framed-avg numerator)
            sb = region(argn, f_lo, f_hi, True, "sum")
            sa = region(argn, f_lo, f_hi, False, "sum")
            isf = arg_tables(argn)["isf"]
            base = c.data.astype(jnp.float64 if isf else jnp.int64)
            lv = c.validity if c.validity is not None else None
            if lv is not None:
                base = jnp.where(lv, base, jnp.asarray(0, base.dtype))
            tot_s = base + sb + sa
            out = out.with_column(name, Column(
                tot_s.astype(c.data.dtype), (gcnt > 0) & live,
                c.dtype.with_nullable(True)))

        # framed AVG assembly from the stitched sum/count temps
        for name, (s, c2, f) in favg_specs.items():
            from ..core.dtypes import Decimal as _DecT
            from ..expr.functions import _div_round_half_up as _divr

            sc = out[s]
            prec, foll = f.frame
            f_lo = jnp.maximum(g_row - jnp.int64(prec), 0)
            f_hi = jnp.minimum(g_row + jnp.int64(foll), tot_row - 1)
            vb = region(f.arg, f_lo, f_hi, True, "vcnt")
            va = region(f.arg, f_lo, f_hi, False, "vcnt")
            gcnt = local[c2].data.astype(jnp.int64) + vb + va
            arg_dt = local[f.arg].dtype
            if arg_dt.is_decimal:
                rdt = _DecT(18, arg_dt.scale + 4, nullable=True)
                d = _divr(sc.data.astype(jnp.int64) * (10 ** 4),
                          jnp.maximum(gcnt, 1))
            else:
                rdt = _F64.with_nullable(True)
                d = (sc.data.astype(jnp.float64)
                     / jnp.maximum(gcnt, 1).astype(jnp.float64))
            out = out.with_column(name, Column(
                d.astype(rdt.jnp_dtype), (gcnt > 0) & live, rdt))

    # adjusted AVG = (sum + carry) / (count + carry), typed like the
    # single-chip running avg
    for name, (s, c2, f) in avg_specs.items():
        from ..core.dtypes import FLOAT64
        from ..core.dtypes import Decimal as DecimalT
        from ..expr.functions import _div_round_half_up

        sc = out[s]
        cc = out[c2]
        arg_dt = local[f.arg].dtype
        cnt = cc.data.astype(jnp.int64)
        ssum = sc.data.astype(jnp.int64)
        if arg_dt.is_decimal:
            rdt = DecimalT(18, arg_dt.scale + 4, nullable=True)
            d = _div_round_half_up(ssum * (10 ** 4), jnp.maximum(cnt, 1))
        else:
            rdt = FLOAT64.with_nullable(True)
            d = ssum / jnp.maximum(cnt, 1).astype(jnp.float64)
        out = out.with_column(
            name, Column(d.astype(rdt.jnp_dtype), cnt > 0, rdt))
    drop = {node.lane_col}
    for s, c2, _f in avg_specs.values():
        drop |= {s, c2}
    for s, c2, _f in favg_specs.values():
        drop |= {s, c2}
    drop |= set(pr_specs.values()) | set(cd_specs.values())
    drop |= {t for t, _k in nt_specs.values()}
    drop |= {t for _k, _f2, t in head_specs.values() if t is not None}
    drop |= {c for _f2, c in frame_specs.values()}
    keep = [nm for nm in out.names if nm not in drop]
    cols = dict(zip(out.names, out.columns))
    return Block(names=tuple(keep), columns=tuple(cols[nm] for nm in keep),
                 sel=out.sel)


def collect_result(out: Block) -> Block:
    """Bring a (possibly sharded) result block to host as one Block."""
    names = out.names
    cols = []
    for c in out.columns:
        data = jax.device_get(c.data)
        validity = jax.device_get(c.validity) if c.validity is not None else None
        cols.append(Column(jnp.asarray(data), None if validity is None else jnp.asarray(validity), c.dtype, c.dictionary, c.concat_sep))
    sel = jnp.asarray(jax.device_get(out.sel_mask()))
    return Block(names=names, columns=tuple(cols), sel=sel)


__all__ = [
    "compile_distributed",
    "shard_block",
    "shard_catalog_blocks",
    "collect_result",
    "ExchangeConfig",
    "AXIS",
]
