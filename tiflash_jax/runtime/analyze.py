"""EXPLAIN ANALYZE with per-operator timings.

Role analog: ``Flash/Statistics/ExecutorStatisticsCollector.h:38`` /
``ExecutionSummary.cpp`` — the reference's pipeline executor stamps each
operator's execution time as rows stream through it.  In this engine a
fragment is ONE fused XLA program, so "time inside operator X" does not
exist at runtime.  The honest equivalent is *subtree differencing*:
compile and time each plan subtree as its own program (with the
carry-chain + checksum discipline from bench.py — async dispatch and
identical-dispatch elision otherwise produce fantasy numbers), then
self_time(node) = t(subtree(node)) - Σ t(subtree(children)), clamped at 0.

Fusion makes this an attribution model, not an exact decomposition — XLA
may overlap a child's work with the parent's — but it is the same model a
human uses when stage-bisecting (and the one that found every Q3
bottleneck so far).  Cost: one XLA compile per node; intended as a
diagnostic, exactly like the reference's EXPLAIN ANALYZE re-execution.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.block import Block, Column
from ..plan import nodes as P


def _children(plan: P.PlanNode) -> List[P.PlanNode]:
    if isinstance(plan, (P.Join, P.CrossJoin)):
        return [plan.probe, plan.build]
    if isinstance(plan, P.Union):
        return list(plan.children)
    if isinstance(plan, P.WithCTE):
        return list(plan.defs.values()) + [plan.child]
    if hasattr(plan, "child"):
        return [plan.child]
    return []


def walk_subtrees(plan: P.PlanNode, path: str = "0"):
    """Pre-order (path, node) pairs; child order mirrors plan structure."""
    yield path, plan
    for i, c in enumerate(_children(plan)):
        yield from walk_subtrees(c, f"{path}.{i}")


def _label(node: P.PlanNode) -> str:
    return type(node).__name__


def block_checksum(block: Block) -> jnp.ndarray:
    """int64 fold of every live output value, so that no operator of a
    timed program can be dead-code eliminated."""
    acc = jnp.int64(0)
    live = block.sel_mask()
    for c in block.columns:
        d = c.data
        if d.dtype == jnp.bool_:
            d = d.astype(jnp.int32)
        mask = live
        if c.validity is not None:
            v = c.validity
            mask = (mask[:, None] & v) if v.ndim == 2 else (mask & v)
        if d.ndim == 2 and mask.ndim == 1:
            mask = mask[:, None]
        if jnp.issubdtype(d.dtype, jnp.floating):
            # fold the exact bits, so any change of value moves the sum
            d = jax.lax.bitcast_convert_type(d.astype(jnp.float64), jnp.int64)
        acc = acc + jnp.sum(jnp.where(mask, d.astype(jnp.int64), 0))
    return acc


def perturb_column(col: Column, carry: jnp.ndarray) -> Column:
    """``col`` with the carry's low bit xor-ed into every value, so that each
    run of a timed chain is a fresh, value-dependent execution.  The range
    stats widen by one to stay an invariant."""
    bit = (carry & jnp.int64(1)).astype(col.data.dtype)
    widened = None if col.stats is None else (col.stats[0] - 1,
                                              col.stats[1] + 1)
    return dataclasses.replace(col, data=col.data ^ bit, stats=widened)


def _perturb_target(tables: Dict[str, Block]) -> Optional[Tuple[str, str]]:
    """A (table, column) safe to flip: integer-typed, not a clustering key."""
    for tname, b in tables.items():
        for name, c in zip(b.names, b.columns):
            if name in (b.clustered_by or ()):
                continue
            if c.data.ndim == 1 and jnp.issubdtype(c.data.dtype, jnp.integer):
                return tname, name
    return None


def _timed_chain(fn, tables, target, K: int, seed: int) -> float:
    carry = jnp.int64(seed)
    t0 = time.time()
    for _ in range(K):
        carry = fn(tables, carry)
    _ = int(carry)  # sync
    return time.time() - t0


def time_subtree(plan: P.PlanNode, tables: Dict[str, Block],
                 k1: int = 2, k2: int = 6, seed_base: int = 1) -> float:
    """Per-iteration seconds for one subtree, via differenced perturbed
    chains (see module docstring)."""
    target = _perturb_target(tables)

    @jax.jit
    def step(tbls, carry):
        if target is not None:
            tname, cname = target
            b = tbls[tname]
            tbls = dict(tbls)
            tbls[tname] = b.with_column(cname, perturb_column(b[cname], carry))
        from ..plan.compiler import execute_plan

        out = execute_plan(plan, tbls)
        return block_checksum(out) + carry * jnp.int64(0x9E3779B1)

    _timed_chain(step, tables, target, 1, seed_base)       # compile
    _timed_chain(step, tables, target, 2, seed_base + 1)   # warm
    t1 = min(_timed_chain(step, tables, target, k1, seed_base + 2 + i)
             for i in range(2))
    t2 = min(_timed_chain(step, tables, target, k2, seed_base + 8 + i)
             for i in range(2))
    return max((t2 - t1) / (k2 - k1), 0.0)


def _has_unbound_cte(node: P.PlanNode, bound: frozenset = frozenset()) -> bool:
    if isinstance(node, P.CTERef):
        return node.name not in bound
    if isinstance(node, P.WithCTE):
        if any(_has_unbound_cte(d, bound) for d in node.defs.values()):
            return True
        return _has_unbound_cte(node.child, bound | frozenset(node.defs))
    return any(_has_unbound_cte(c, bound) for c in _children(node))


def explain_analyze(
    plan: P.PlanNode,
    tables: Dict[str, Block],
    k1: int = 2,
    k2: int = 6,
) -> List[Dict]:
    """Per-node timing report for an exchange-free fragment.

    Returns a list of rows (pre-order): path, operator, subtree seconds,
    self seconds.  One XLA compile per node — a diagnostic tool."""
    entries = list(walk_subtrees(plan))
    sub_times: Dict[str, Optional[float]] = {}
    for i, (path, node) in enumerate(entries):
        if isinstance(node, (P.ExchangeSender, P.ExchangeReceiver)):
            sub_times[path] = None
            continue
        if _has_unbound_cte(node, frozenset()):
            sub_times[path] = None  # subtree not runnable standalone
            continue
        try:
            sub_times[path] = time_subtree(plan=node, tables=tables,
                                           k1=k1, k2=k2, seed_base=37 * i + 1)
        except Exception:
            sub_times[path] = None

    report = []
    for path, node in entries:
        t = sub_times.get(path)
        self_t = None
        if t is not None:
            child_sum = 0.0
            ok = True
            for cp, _ in entries:
                if cp.startswith(path + ".") and cp.count(".") == path.count(".") + 1:
                    ct = sub_times.get(cp)
                    if ct is None:
                        ok = False
                        break
                    child_sum += ct
            if ok:
                self_t = max(t - child_sum, 0.0)
        report.append({
            "path": path,
            "operator": _label(node),
            "detail": str(node) if len(str(node)) < 120 else _label(node),
            "subtree_s": t,
            "self_s": self_t,
        })
    return report


def format_analyze(report: List[Dict]) -> str:
    lines = ["path        operator              subtree       self"]
    for r in report:
        sub = "-" if r["subtree_s"] is None else f"{r['subtree_s']*1e3:9.2f}ms"
        slf = "-" if r["self_s"] is None else f"{r['self_s']*1e3:9.2f}ms"
        indent = "  " * r["path"].count(".")
        lines.append(f"{r['path']:<10}  {indent}{r['operator']:<20.20} {sub:>11} {slf:>10}")
    return "\n".join(lines)


__all__ = ["explain_analyze", "format_analyze", "time_subtree", "walk_subtrees"]
