"""Fragment compiler: plan tree -> one traced/jitted JAX function.

Role analog: the whole execution stack L5-L7 of the reference —
``Planner::execute`` (``Flash/Planner/Planner.cpp:42``),
``PhysicalPlanNode::buildPipeline`` / ``buildBlockInputStream``
(``Flash/Planner/PhysicalPlanNode.h:70-110``) and the
``PipelineExecutor``/``TaskScheduler`` machinery
(``Flash/Executor/PipelineExecutor.cpp:88``).

On the device none of that scheduling exists at runtime: a plan fragment is
*compiled* — each node contributes traced ops, XLA fuses/schedules, and the
"executor" is a single device computation.  Filters stay lazy selection
masks; pipeline-breaker nodes (agg/join-build/sort) are just ops that
consume the mask.  Host-side orchestration (fragments, shuffles, capacity
retries) lives in mpp/runner.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.block import Block
from ..expr.compile import ExprEvaluator
from ..ops import join as J
from ..ops import scan_agg as SA
from ..ops.aggregate import auto_passthrough_aggregate, hash_aggregate
from ..ops.expand import expand_block
from ..ops.sort import limit_block, sort_block, top_n
from ..ops.window import window_block
from . import nodes as P


@dataclasses.dataclass
class Diagnostics:
    """Traced scalars surfaced to the host runner: overflow flags trigger
    capacity-doubling re-runs (SURVEY.md §7), row counts feed execution
    summaries (``Flash/Statistics/ExecutorStatisticsCollector.h``)."""

    overflows: Dict[str, jnp.ndarray]
    rows: Dict[str, jnp.ndarray]
    # published runtime filters: rf_id -> [(min, max, sorted_set|None), ...]
    rf: Dict[str, list] = dataclasses.field(default_factory=dict)
    rf_in_set_max: int = 1 << 20
    # runtime error channel: message -> scalar bool flag (any live row
    # hit a per-row EvalError; raised host-side after execution —
    # runtime/errors.py:raise_runtime_errors)
    errors: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)


def execute_plan(plan: P.PlanNode, tables: Dict[str, Block], diag: Optional[Diagnostics] = None) -> Block:
    """Trace-time recursive walk.  Call under jit for fused execution."""
    if diag is None:
        diag = Diagnostics({}, {})
    return _exec(plan, tables, diag, [0])


def _exec(node: P.PlanNode, tables: Dict[str, Block], diag: Diagnostics, ctr: List[int]) -> Block:
    # profiler attribution: each node's traced ops carry its scope name, so
    # XProf/Perfetto traces group compute per operator (the
    # ExecutorStatisticsCollector analog for a fused program; subtree
    # *timings* come from runtime/analyze.py)
    with jax.named_scope(type(node).__name__):
        return _exec_node(node, tables, diag, ctr)


def _drain_eval_errors(ev: ExprEvaluator, block: Block, diag: Diagnostics) -> None:
    """Fold an evaluator's per-row error lanes into scalar flags, masked
    to the block's LIVE rows (filtered-out rows cannot error — the
    reference only evaluates selected rows)."""
    for mask, msg in ev.runtime_errors:
        if block.sel is not None:
            mask = mask & block.sel
        flag = jnp.any(mask)
        prev = diag.errors.get(msg)
        diag.errors[msg] = flag if prev is None else (prev | flag)
    ev.runtime_errors.clear()


def _fused_scan_aggregate(node: P.Aggregation, tables: Dict[str, Block],
                          diag: Diagnostics, ctr: List[int]):
    """``node`` through the fused scan-aggregate kernel
    (``ops/scan_agg.py``) when the backend has it and its child is
    Selection/Projection nodes over one TableScan of 1-D NULL-free
    columns; else None, with ``diag`` and ``ctr`` untouched."""
    route = SA.kernel_route()
    scan = node.child
    while isinstance(scan, (P.Selection, P.Projection)):
        scan = scan.child
    if route is None or node.mode == "auto" or not isinstance(scan, P.TableScan):
        return None
    table = tables[scan.table]
    names = list(scan.columns) if scan.columns is not None else list(table.names)
    if table.sel is not None or any(
            table[c].validity is not None or table[c].data.ndim != 1
            for c in names):
        return None
    # the chain over the whole table, for its static shape only
    pdiag = Diagnostics({}, {}, rf=diag.rf, rf_in_set_max=diag.rf_in_set_max)
    pctr = [ctr[0]]
    block = _exec(node.child, tables, pdiag, pctr)
    if pdiag.overflows or pdiag.errors:
        return None

    def tile_chain(cols, in_bounds):
        tile = Block(names=tuple(names),
                     columns=tuple(cols[c] for c in names), sel=in_bounds)
        return _exec(node.child, {scan.table: tile}, Diagnostics({}, {}),
                     [ctr[0]])

    res = SA.fused_aggregate({c: table[c] for c in names}, tile_chain, block,
                             list(node.keys), list(node.aggs),
                             interpret=(route == "interpret"))
    if res is not None:
        ctr[0] = pctr[0]
        diag.rows.update(pdiag.rows)
    return res


def _exec_node(node: P.PlanNode, tables: Dict[str, Block], diag: Diagnostics, ctr: List[int]) -> Block:
    ctr[0] += 1
    nid = f"{type(node).__name__}_{ctr[0]}"

    if isinstance(node, P.TableScan):
        block = tables[node.table]
        if node.columns is not None:
            block = block.select(list(node.columns))
        diag.rows[nid] = block.num_rows()
        return block

    if isinstance(node, P.Selection):
        child = _exec(node.child, tables, diag, ctr)
        ev = ExprEvaluator(child)
        cond = ev.evaluate(node.cond)
        _drain_eval_errors(ev, child, diag)
        mask = cond.data.astype(jnp.bool_)
        if cond.validity is not None:
            mask = mask & cond.validity  # NULL condition == not selected
        out = child.and_sel(mask)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.AddColumns):
        child = _exec(node.child, tables, diag, ctr)
        ev = ExprEvaluator(child)
        out = child
        for name, e in node.exprs.items():
            out = out.with_column(name, ev.evaluate(e))
        _drain_eval_errors(ev, child, diag)
        return out

    if isinstance(node, P.Projection):
        from ..expr.nodes import ColumnRef

        child = _exec(node.child, tables, diag, ctr)
        ev = ExprEvaluator(child)
        cols = {name: ev.evaluate(e) for name, e in node.exprs.items()}
        _drain_eval_errors(ev, child, diag)
        out = Block.from_dict(cols, sel=child.sel)
        # row order is unchanged: clustering survives through bare-column
        # passthroughs (renames included)
        if child.clustered_by:
            rename = {
                e.name: out_name
                for out_name, e in node.exprs.items()
                if isinstance(e, ColumnRef)
            }
            kept = []
            for k in child.clustered_by:
                if k not in rename:
                    break
                kept.append(rename[k])
            if kept:
                out = dataclasses.replace(out, clustered_by=tuple(kept))
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Aggregation):
        res = _fused_scan_aggregate(node, tables, diag, ctr)
        if res is not None:
            diag.rows[nid] = res.num_groups
            return res.block
        child = _exec(node.child, tables, diag, ctr)
        if node.mode == "auto":
            res = auto_passthrough_aggregate(child, list(node.keys), list(node.aggs))
        else:
            res = hash_aggregate(child, list(node.keys), list(node.aggs), node.num_slots)
        diag.overflows[nid] = res.overflow
        diag.rows[nid] = res.num_groups
        return res.block

    if isinstance(node, P.Expand):
        child = _exec(node.child, tables, diag, ctr)
        out = expand_block(child, [list(s) for s in node.grouping_sets], node.gid_name)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.CrossJoin):
        probe = _exec(node.probe, tables, diag, ctr)
        build = _exec(node.build, tables, diag, ctr)
        cap = node.output_capacity or probe.capacity
        out, needed = J.cross_join(probe, build, cap)
        diag.overflows[nid] = needed
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Join):
        from ..mpp.runner import _publish_runtime_filter

        if node.rf_id is not None:
            build = _exec(node.build, tables, diag, ctr)
            _publish_runtime_filter(node, build, diag.rf, None,
                                    diag.rf_in_set_max)
            probe = _exec(node.probe, tables, diag, ctr)
        else:
            probe = _exec(node.probe, tables, diag, ctr)
            build = _exec(node.build, tables, diag, ctr)
        cap = None if node.unique_build else node.output_capacity
        if cap is None and not node.unique_build:
            # default: assume 1:1-ish expansion, probe capacity
            cap = probe.capacity
        joined, extras = J.hash_join_with_tail(
            probe, build, list(node.probe_keys), list(node.build_keys),
            kind=node.kind, output_capacity=cap,
            build_payload=node.build_payload,
        )
        diag.overflows[nid] = extras["overflow"]
        diag.rows[nid] = joined.num_rows()
        return joined

    if isinstance(node, P.RuntimeFilterApply):
        from ..mpp.runner import _apply_runtime_filter

        child = _exec(node.child, tables, diag, ctr)
        out = _apply_runtime_filter(node, child, diag.rf)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.TopN):
        child = _exec(node.child, tables, diag, ctr)
        out = top_n(child, list(node.sort_keys), node.limit)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Sort):
        child = _exec(node.child, tables, diag, ctr)
        out = sort_block(child, list(node.sort_keys))
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Limit):
        child = _exec(node.child, tables, diag, ctr)
        out = limit_block(child, node.limit)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Window):
        child = _exec(node.child, tables, diag, ctr)
        out = window_block(
            child, list(node.partition_by), list(node.order_by), list(node.funcs)
        )
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.Union):
        from ..exchange.skew import concat_blocks

        parts = [_exec(c, tables, diag, ctr) for c in node.children]
        out = parts[0]
        for p in parts[1:]:
            out = concat_blocks(out, p)
        diag.rows[nid] = out.num_rows()
        return out

    if isinstance(node, P.WithCTE):
        tables = dict(tables)
        for name, d in node.defs.items():
            tables["__cte_" + name] = _exec(d, tables, diag, ctr)
        return _exec(node.child, tables, diag, ctr)

    if isinstance(node, P.CTERef):
        try:
            return tables["__cte_" + node.name]
        except KeyError:
            raise KeyError(f"CTE {node.name!r} not defined by an enclosing WithCTE") from None

    if isinstance(node, (P.ExchangeSender, P.ExchangeReceiver)):
        raise ValueError(
            "exchange nodes mark fragment boundaries — run via mpp.runner, "
            "not the single-fragment compiler"
        )

    raise NotImplementedError(f"plan node {type(node).__name__}")


def compile_fragment(
    plan: P.PlanNode,
    collect_rows: bool = False,
    rf_in_set_max: int = 1 << 20,
) -> Callable[[Dict[str, Block]], Tuple[Block, Dict[str, jnp.ndarray]]]:
    """jit-compile a whole exchange-free fragment.

    Returns fn(tables) -> (result block, overflow flags[, per-node rows])
    — per-node live-row counts feed EXPLAIN ANALYZE summaries.  Retraces
    only when table capacities/dtypes change (pytree structure)."""

    @jax.jit
    def run(tables: Dict[str, Block]):
        from ..runtime.errors import RTERR_PREFIX

        diag = Diagnostics({}, {}, rf_in_set_max=rf_in_set_max)
        out = execute_plan(plan, tables, diag)
        # runtime-error flags ride the overflow dict under a reserved
        # prefix (runtime/errors.py:split_runtime_errors peels them off)
        flags = dict(diag.overflows)
        for msg, v in diag.errors.items():
            flags[RTERR_PREFIX + msg] = v
        if collect_rows:
            return out, flags, diag.rows
        return out, flags

    return run


__all__ = ["execute_plan", "compile_fragment", "Diagnostics"]
