"""QueryRunner: the host-side query executor with capacity-retry.

Role analog: L7 of the reference — ``QueryExecutor`` /
``PipelineExecutor::execute`` (``Flash/Executor/PipelineExecutor.cpp:88``)
plus the spill/restore machinery it drives: where TiFlash reacts to memory
pressure by spilling partitions and running restore rounds
(``Interpreters/Join.h:95-100``, ``Aggregator.cpp:1268``), a shape-static
XLA program reacts to *capacity overflow* by re-running the (cheap,
cached-compile) program with doubled capacities.  Same contract — bounded
memory, data-dependent sizes — different mechanism.

Also the home of execution summaries, metrics and failpoint trigger
points (``Flash/executeQuery.cpp:105-196`` analog).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.block import Block
from ..mpp.runner import (
    AXIS,
    ExchangeConfig,
    collect_result,
    compile_distributed,
    shard_catalog_blocks,
)
from ..plan import nodes as P
from ..plan.compiler import compile_fragment
from .failpoint import fail_point
from .metrics import METRICS
from .settings import Settings
from .summary import ExecutionSummary


def enumerate_plan(plan: P.PlanNode) -> Tuple[Dict[int, P.PlanNode], Dict[int, P.ExchangeReceiver]]:
    """Assign the same DFS pre-order ids the executors use.

    Returns (node_ids, exchange_ids); overflow keys are
    f"{type(node).__name__}_{id}" and f"Exchange_{xid}"."""
    nodes: Dict[int, P.PlanNode] = {}
    exchanges: Dict[int, P.ExchangeReceiver] = {}
    ctr = [0]

    def walk(node: P.PlanNode):
        ctr[0] += 1
        nodes[ctr[0]] = node
        if isinstance(node, P.ExchangeReceiver):
            ctr[0] += 1
            exchanges[ctr[0]] = node
            walk(node.source.child)  # sender itself carries no id
            return
        if isinstance(node, P.Join):
            if node.rf_id is not None:
                walk(node.build)  # rf joins execute build first
                walk(node.probe)
            else:
                walk(node.probe)
                walk(node.build)
            return
        if isinstance(node, P.SkewShuffleJoin):
            walk(node.probe)
            walk(node.build)
            # the runner assigns two internal exchange ids after the children
            ctr[0] += 1
            exchanges[ctr[0]] = node  # probe-side shuffle
            ctr[0] += 1
            exchanges[ctr[0]] = node  # build-side shuffle
            return
        for c in node.children:
            walk(c)

    walk(plan)
    return nodes, exchanges


class QueryRunner:
    """Compile-and-run with overflow retries.

    One instance per (plan, mesh) pair; the jit cache keys on table
    shapes, so repeated runs over same-shaped tables are compile-free."""

    def __init__(
        self,
        plan: P.PlanNode,
        mesh=None,
        settings: Optional[Settings] = None,
        cancel: "Optional[object]" = None,
        logical_plan: Optional[P.PlanNode] = None,
    ):
        # cooperative cancellation flag (runtime/cancel.CancelFlag);
        # checked at every host orchestration boundary below
        from .cancel import CancelFlag

        # the exchange-free original (when the caller pre-distributed):
        # out-of-core fallbacks match against THIS shape
        self.logical_plan = logical_plan
        self.cancel: "Optional[CancelFlag]" = cancel
        self.settings = settings or Settings()
        if self.settings.enable_plan_rewrites:
            # the optimizer pass TiDB runs before shipping fragments:
            # aggregation pushdown + column pruning (plan/rewrite.py);
            # distribute_plan applies the same pass itself
            from ..plan.rewrite import eager_aggregation, prune_columns

            has_exchange = "Exchange" in plan.pretty()
            if not has_exchange:
                plan = prune_columns(eager_aggregation(plan))
        self._apply_agg_defaults(plan)
        self.plan = plan
        self.mesh = mesh
        self.cfg = ExchangeConfig(
            shuffle_factor=self.settings.default_shuffle_factor,
            rf_in_set_max_build=self.settings.rf_in_set_max_build,
        )
        self._compiled = None
        self._compile_s = 0.0

    def _apply_agg_defaults(self, plan: P.PlanNode) -> None:
        """Session-setting defaults for per-aggregate knobs the plan left
        unset (the reference applies group_concat_max_len the same way:
        a session setting unless the plan overrides)."""
        import dataclasses as _dc

        nodes, _ = enumerate_plan(plan)
        for node in nodes.values():
            if not isinstance(node, P.Aggregation):
                continue
            aggs = list(node.aggs)
            changed = False
            for i, a in enumerate(aggs):
                if a.param is None and a.func == "group_concat":
                    aggs[i] = _dc.replace(
                        a, param=float(self.settings.group_concat_max_items))
                    changed = True
                elif a.param is None and a.func in (
                    "approx_count_distinct", "approx_cd_partial",
                    "approx_cd_final",
                ):
                    aggs[i] = _dc.replace(
                        a, param=float(self.settings.approx_distinct_sketch_k))
                    changed = True
            if changed:
                node.aggs = aggs

    # -- plan rewriting on overflow ------------------------------------

    def _grow(self, flagged: Dict[str, int]) -> None:
        """Overflow values carry the required capacity — grow to 1.25x the
        requirement in one step (vs the reference's restore rounds)."""
        nodes, exchanges = enumerate_plan(self.plan)
        for key, needed in flagged.items():
            target = max(int(needed * 1.25) + 1, 16)
            kind, _, sid = key.rpartition("_")
            nid = int(sid)
            if kind == "Exchange":
                self.cfg.capacities[nid] = max(
                    target, self.cfg.capacities.get(nid, 0) * 2
                )
                METRICS.counter("shuffle_overflows_total").inc()
                continue
            node = nodes.get(nid)
            if isinstance(node, P.Aggregation):
                node.num_slots = max(target, (node.num_slots or 0) * 2)
            elif isinstance(node, (P.Join, P.CrossJoin, P.SkewShuffleJoin)):
                node.output_capacity = max(target, (node.output_capacity or 0) * 2)
                # a unique-path overflow means the uniqueness promise was
                # false — retry on the general (duplicate-correct) path
                if getattr(node, "unique_build", False):
                    node.unique_build = False
        self._compiled = None  # force recompile with new capacities

    # -- execution ------------------------------------------------------

    def _compile(self):
        if self._compiled is not None:
            return self._compiled
        t0 = time.perf_counter()
        if self.mesh is None:
            # operator row limits read the per-node counters, so force
            # collection on when any is set
            want_rows = self.settings.collect_summaries or any((
                self.settings.max_rows_to_group_by,
                self.settings.max_rows_in_join,
                self.settings.max_rows_to_sort))
            inner = compile_fragment(
                self.plan, collect_rows=want_rows,
                rf_in_set_max=self.settings.rf_in_set_max_build,
            )

            def wrap(tables):
                r = inner(tables)
                return r if len(r) == 3 else (r[0], r[1], {})

            self._compiled = wrap
        else:
            self._compiled = compile_distributed(
                self.plan, self.mesh, axis=self.settings.mesh_axis, cfg=self.cfg
            )
        self._compile_s += time.perf_counter() - t0
        METRICS.counter("fragments_compiled_total").inc()
        METRICS.counter("compile_seconds_total").inc(
            time.perf_counter() - t0)
        return self._compiled

    def run(self, tables: Dict[str, Block]) -> Tuple[Block, ExecutionSummary]:
        import time

        from .cancel import cancel_scope
        from ..expr.compile import query_clock, query_now_us, query_timezone

        # pin the query clock once so NOW()/CURDATE()/RAND() agree across
        # fragments and capacity retries (reference: timestamp fixed in the
        # query Context at entry, ``Interpreters/Context.h``); a
        # query_timestamp_us setting overrides for reproducible runs
        now_us = self.settings.query_timestamp_us or query_now_us()
        # max_execution_time analog: deadline enforced at every
        # cancellation checkpoint (admission, retries, out-of-core chunks)
        deadline = None
        if self.settings.max_execution_time_ms > 0:
            deadline = time.monotonic() + self.settings.max_execution_time_ms / 1e3
        from ..expr.compile import parse_tz_offset_us

        with cancel_scope(self.cancel, deadline), query_clock(now_us), \
                query_timezone(parse_tz_offset_us(self.settings.time_zone)):
            return self._run_cancellable(tables)

    def _run_cancellable(self, tables) -> Tuple[Block, ExecutionSummary]:
        import jax

        from .cancel import checkpoint

        checkpoint()
        if not getattr(self, "_autosized", False):
            # fill unset capacities from catalog stats + sampled NDV
            # (convertToTwoLevel analog; retry loop = safety net)
            self._autosized = True
            from ..plan.auto import autosize_plan

            try:
                autosize_plan(self.plan, tables, settings=self.settings)
            except Exception:  # estimation must never sink a query
                pass
        fail_point("exception_before_fragment_run")
        self._check_preflight_limits(tables)
        from .memory import MemoryLimitError, check_memory

        try:
            check_memory(self.plan, tables, self.settings.max_bytes_per_device)
            # per-operator external-memory thresholds
            # (Settings.h:138/140/321): force the out-of-core path for the
            # matching operator shape even under the global quota
            s = self.settings
            any_threshold = (s.max_bytes_before_external_group_by
                             or s.max_bytes_before_external_join
                             or s.max_bytes_before_external_sort)
            if self.mesh is not None and s.enable_spill and any_threshold:
                # out-of-core composition is single-chip only for now; say
                # so once instead of silently ignoring the knobs (ADVICE r2)
                if not getattr(self, "_warned_mesh_thresholds", False):
                    self._warned_mesh_thresholds = True
                    from .logging import get_logger

                    get_logger("tiflash_jax.executor").info(
                        "max_bytes_before_external_* thresholds apply to "
                        "single-chip runs only; ignored under a mesh")
            if self.mesh is None and s.enable_spill and any_threshold:
                from ..plan import nodes as P
                from .memory import estimate_operator_bytes
                from .outofcore import (chunkable, grace_spec, groupagg_spec,
                                        sliced_spec)

                gb, jb, sb = (s.max_bytes_before_external_group_by,
                              s.max_bytes_before_external_join,
                              s.max_bytes_before_external_sort)
                # each threshold compares against ITS operator's working
                # set (inputs + transients), not the whole plan's
                est_gb = estimate_operator_bytes(
                    self.plan, tables, (P.Aggregation,)) if gb else 0
                est_jb = estimate_operator_bytes(
                    self.plan, tables,
                    (P.Join, P.SkewShuffleJoin, P.CrossJoin)) if jb else 0
                est_sb = estimate_operator_bytes(
                    self.plan, tables, (P.Sort, P.TopN)) if sb else 0
                if (gb and est_gb > gb and (chunkable(self.plan)
                                            or groupagg_spec(self.plan))) or \
                   (jb and est_jb > jb and grace_spec(self.plan) is not None) or \
                   (sb and est_sb > sb and sliced_spec(self.plan) is not None):
                    raise MemoryLimitError(
                        f"operator working set (agg~{est_gb} join~{est_jb} "
                        f"sort~{est_sb} B) exceeds its external-memory "
                        "threshold")
        except MemoryLimitError:
            # out-of-core fallbacks (the spill analogs): chunked partial
            # aggregation, grace hash join, or external sort/topN
            from .outofcore import (
                chunkable, grace_spec, groupagg_spec, run_chunked_aggregate,
                run_grace_join, run_groupagg, run_sliced, sliced_spec,
            )

            mode = None
            if self.mesh is None and self.settings.enable_spill:
                if chunkable(self.plan):
                    mode = "chunked"
                elif groupagg_spec(self.plan) is not None:
                    mode = "groupagg"
                elif grace_spec(self.plan) is not None:
                    mode = "grace"
                elif sliced_spec(self.plan) is not None:
                    mode = "sliced"
            elif self.mesh is not None and self.settings.enable_spill \
                    and grace_spec(self.logical_plan or self.plan) \
                    is not None:
                # config-5 composition: grace partitions x in-partition
                # distributed execution over the mesh
                mode = "grace"
            if mode is None:
                raise
            from .logging import get_logger

            get_logger("tiflash_jax.executor").info(
                "memory limit exceeded: switching to %s out-of-core execution",
                mode,
            )
            from .memory import default_outofcore_budget, plan_chunk_rows

            budget = (self.settings.max_bytes_per_device
                      or default_outofcore_budget())
            per_op = {"chunked": self.settings.max_bytes_before_external_group_by,
                      "groupagg": self.settings.max_bytes_before_external_group_by,
                      "grace": self.settings.max_bytes_before_external_join,
                      "sliced": self.settings.max_bytes_before_external_sort}[mode]
            if per_op:
                budget = min(budget, per_op)
            # the threshold is a TRIGGER; as a partition/chunk SIZING
            # budget it must stay proportional to the inputs or a
            # degenerate setting (force-spill with 1 byte) explodes the
            # partition count into thousands of tiny per-partition
            # programs + spill files (SF10 rehearsal: P_=4096, 14k
            # ~50-byte .spl files, ~30 min of fixed dispatch cost).
            # inputs/64 keeps >= ~16 partitions at 4x headroom — real
            # out-of-core behavior — while leaving realistic thresholds
            # untouched
            from .memory import block_bytes

            budget = max(budget,
                         sum(block_bytes(b) for b in tables.values()) // 64)
            chunk_rows = plan_chunk_rows(
                self.plan, tables, budget,
                work_factor=self.settings.outofcore_work_factor,
            )
            if self.settings.max_spilled_rows_per_file:
                chunk_rows = min(chunk_rows,
                                 self.settings.max_spilled_rows_per_file)
            if mode == "chunked":
                out = run_chunked_aggregate(self.plan, tables, chunk_rows)
            elif mode == "groupagg":
                out = run_groupagg(self.plan, tables, budget,
                                   spill_dir=self.settings.spill_dir,
                                   nthreads=self.settings.max_threads)
            elif mode == "grace":
                out = run_grace_join(
                    (self.logical_plan or self.plan) if self.mesh is not None
                    else self.plan, tables, budget,
                    mesh=self.mesh,
                    spill_dir=self.settings.spill_dir,
                    nthreads=self.settings.max_threads)
            else:
                out = run_sliced(self.plan, tables, chunk_rows,
                                 spill_dir=self.settings.spill_dir,
                                 nthreads=self.settings.max_threads)
            summary = ExecutionSummary(
                plan_text=self.plan.pretty() + f"\n  [{mode} out-of-core]",
                num_devices=1 if self.mesh is None
                else int(np.prod(list(self.mesh.shape.values()))),
            )
            summary.result_rows = int(np.asarray(out.num_rows()))
            METRICS.counter("queries_total").inc()
            return out, summary
        if self.settings.resource_group:
            from .resource import RESOURCE_GROUPS, to_ru

            est_rows = sum(b.capacity for b in tables.values())
            if not RESOURCE_GROUPS.admit(
                self.settings.resource_group, to_ru(est_rows, 0.0)
            ):
                raise RuntimeError(
                    f"resource group {self.settings.resource_group!r} "
                    "rejected query (RU budget exhausted)"
                )
        summary = ExecutionSummary(
            plan_text=self.plan.pretty(),
            backend=jax.default_backend(),
            num_devices=1 if self.mesh is None else int(np.prod(list(self.mesh.shape.values()))),
        )
        METRICS.counter("queries_total").inc()
        t_start = time.perf_counter()
        import contextlib

        prof = (
            jax.profiler.trace(self.settings.profile_dir)
            if self.settings.profile_dir
            else contextlib.nullcontext()
        )
        from .memory import QueryMemoryScope

        with prof, QueryMemoryScope() as mem:
            result = self._run_with_retries(tables, summary, t_start)
        summary.peak_device_bytes = mem.peak_bytes
        summary.device_bytes_delta = mem.delta_bytes
        lim = self.settings.max_bytes_per_device
        if lim is not None and mem.peak_bytes > lim:
            from .logging import get_logger

            # a jitted program can't be interrupted mid-flight; the peak
            # exceeding quota means the pre-flight estimate undershot —
            # surface it so the estimator can be recalibrated
            get_logger("tiflash_jax.executor").warning(
                "runtime peak %d bytes exceeded quota %d (pre-flight "
                "estimate undershot)", mem.peak_bytes, lim,
            )
        return result

    def _check_preflight_limits(self, tables) -> None:
        """max_rows_to_read / max_subquery_depth (Settings.h limits):
        host-known facts, checked before launch."""
        s = self.settings
        if s.max_rows_to_read:
            from ..plan import nodes as P

            scanned, seen = 0, set()

            def walk(n):
                nonlocal scanned
                if isinstance(n, P.TableScan) and n.table not in seen \
                        and n.table in tables:
                    seen.add(n.table)
                    scanned += tables[n.table].capacity
                for c in n.children:
                    walk(c)

            walk(self.plan)
            if scanned > s.max_rows_to_read:
                from .errors import LIMIT_EXCEEDED, EngineError

                raise EngineError(
                    f"query reads {scanned} rows > max_rows_to_read="
                    f"{s.max_rows_to_read}", LIMIT_EXCEEDED)
        if s.max_subquery_depth:
            def depth(n):
                return 1 + max((depth(c) for c in n.children), default=0)

            d = depth(self.plan)
            if d > s.max_subquery_depth:
                from .errors import LIMIT_EXCEEDED, EngineError

                raise EngineError(
                    f"plan depth {d} > max_subquery_depth="
                    f"{s.max_subquery_depth}", LIMIT_EXCEEDED)
        if s.max_ast_depth:
            # Settings.h max_ast_depth: expression-tree depth guard
            # (pre-flight — the reference's exceeds-depth error)
            from ..expr.nodes import Call as _C, Cast as _Ca
            from ..plan import nodes as P

            def edepth(e):
                if isinstance(e, _C):
                    return 1 + max((edepth(a) for a in e.args), default=0)
                if isinstance(e, _Ca):
                    return 1 + edepth(e.arg)
                return 1

            def plan_exprs(n):
                for attr in ("exprs", "predicate", "condition"):
                    v = getattr(n, attr, None)
                    if isinstance(v, dict):
                        yield from v.values()
                    elif v is not None and hasattr(v, "__class__") \
                            and v.__class__.__module__.endswith(
                                "expr.nodes"):
                        yield v
                for c in n.children:
                    yield from plan_exprs(c)

            worst = max((edepth(e) for e in plan_exprs(self.plan)),
                        default=0)
            if worst > s.max_ast_depth:
                from .errors import LIMIT_EXCEEDED, EngineError

                raise EngineError(
                    f"expression depth {worst} > max_ast_depth="
                    f"{s.max_ast_depth}", LIMIT_EXCEEDED)

    def _check_row_limits(self, summary) -> None:
        """Operator row limits against the per-node EXPLAIN ANALYZE
        counters (throw-after semantics: a jitted program can't be
        stopped mid-stream; Settings.h OverflowMode::THROW analog)."""
        s = self.settings
        checks = (("Aggregation", s.max_rows_to_group_by,
                   "max_rows_to_group_by"),
                  ("Join", s.max_rows_in_join, "max_rows_in_join"),
                  ("Sort", s.max_rows_to_sort, "max_rows_to_sort"))
        for prefix, lim, name in checks:
            if not lim:
                continue
            for nid, rows in summary.node_rows.items():
                if nid.startswith(prefix) and rows > lim:
                    from .errors import LIMIT_EXCEEDED, EngineError

                    raise EngineError(
                        f"{nid} produced {rows} rows > {name}={lim}",
                        LIMIT_EXCEEDED)

    def _run_with_retries(self, tables, summary, t_start):
        import jax

        from .logging import get_logger

        log = get_logger("tiflash_jax.executor")
        from .cancel import checkpoint

        from .syncpoint import sync_point

        for attempt in range(self.settings.max_capacity_retries + 1):
            sync_point("executor.attempt")
            checkpoint()  # between retry attempts (MPPTask::abort analog)
            fn = self._compile()
            checkpoint()
            res = fn(tables)
            out, flags = res[0], res[1]
            node_rows = res[2] if len(res) == 3 else {}
            jax.block_until_ready(out)
            checkpoint()
            from .errors import raise_runtime_errors, split_runtime_errors

            overflows, rterrs = split_runtime_errors(flags)
            flagged = {
                k: int(np.asarray(v).max())
                for k, v in overflows.items()
                if int(np.asarray(v).max()) > 0
            }
            if not flagged:
                # capacity clean: surface any per-row evaluation errors
                # (a retry-worthy overflow wins — its rows are garbage)
                raise_runtime_errors(rterrs)
                break
            fail_point("exception_during_retry")
            log.info("capacity overflow, retrying: %s", flagged)
            summary.retries += 1
            summary.overflow_nodes.extend(flagged)
            METRICS.counter("capacity_retries_total").inc()
            if attempt == self.settings.max_capacity_retries:
                raise RuntimeError(
                    f"capacity overflow persisted after "
                    f"{self.settings.max_capacity_retries} retries: {flagged}"
                )
            self._grow(flagged)
        summary.wall_seconds = time.perf_counter() - t_start
        summary.compile_seconds = self._compile_s
        summary.node_rows = {k: int(np.asarray(v)) for k, v in node_rows.items()}
        log.info(
            "query done: wall=%.3fs retries=%d",
            summary.wall_seconds, summary.retries,
        )
        METRICS.counter("query_seconds_total").inc(summary.wall_seconds)
        result = collect_result(out) if self.mesh is not None else out
        summary.result_rows = int(np.asarray(result.num_rows()))
        self._check_row_limits(summary)
        s = self.settings
        if s.max_result_rows and summary.result_rows > s.max_result_rows:
            if s.result_overflow_mode == "break":
                # truncate to the first max_result_rows live rows
                # (OverflowMode::BREAK analog)
                import jax.numpy as jnp

                live = result.sel_mask()
                keep = jnp.cumsum(live.astype(jnp.int64)) <= s.max_result_rows
                result = result.and_sel(keep)
                summary.result_rows = s.max_result_rows
            else:
                from .errors import LIMIT_EXCEEDED, EngineError

                raise EngineError(
                    f"result has {summary.result_rows} rows > "
                    f"max_result_rows={s.max_result_rows}", LIMIT_EXCEEDED)
        METRICS.counter("rows_returned_total").inc(summary.result_rows)
        fail_point("exception_after_fragment_run")
        return result, summary


def run_query(
    plan: P.PlanNode,
    tables: Dict[str, Block],
    mesh=None,
    settings: Optional[Settings] = None,
) -> Tuple[Block, ExecutionSummary]:
    """One-shot convenience: shard tables if a mesh is given, run with
    retries, return (host-collected block, summary).

    A LOGICAL plan (no Exchange nodes) handed a mesh is auto-distributed
    first — running it as-is would silently return unmerged per-shard
    results (each device aggregating only its shard)."""
    if mesh is not None:
        if "Exchange" not in plan.pretty():
            import numpy as _np

            from ..plan.auto import distribute_plan

            stats = {name: blk.capacity for name, blk in tables.items()}
            n_dev = int(_np.prod(list(mesh.shape.values())))
            logical = plan
            plan = distribute_plan(plan, stats, n_dev)
            tables = shard_catalog_blocks(tables, mesh)
            return QueryRunner(plan, mesh=mesh, settings=settings,
                               logical_plan=logical).run(tables)
        tables = shard_catalog_blocks(tables, mesh)
    return QueryRunner(plan, mesh=mesh, settings=settings).run(tables)


__all__ = ["QueryRunner", "run_query", "enumerate_plan"]
