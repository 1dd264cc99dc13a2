"""BASELINE config-5 rehearsal: Q3-shape join + high-cardinality
group-by at SF10 on ONE card, each run twice —
in-memory and FORCED through the out-of-core paths (grace hash join /
group-hash partitioned aggregation + the native disk spiller) — with
result parity asserted between the two.

SF10 exercises the identical code paths the
SF100 config would per host (grace partitioning, spill files, chunked
re-aggregation).  The CPU-side composition of out-of-core x 8-device
mesh is tests/test_outofcore_distributed.py.

Reference discipline: multi-node MPP exercised without a cluster,
``dbms/src/Flash/tests/gtest_compute_server.cpp``.

Emits one JSON line per phase to stdout; run under nohup with a log.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import jax
import jax.numpy as jnp

import tiflash_jax  # noqa: F401
from tiflash_jax.expr.nodes import col
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.executor import QueryRunner
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.storage.tpch import generate_tpch

SF = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
# optional phase subset, e.g. `rehearse_sf10.py 10 q3_grace,hc` — remote
# compiles are load-dependent (30s-10+ min/program); a retry after a
# wedge should not pay for already-recorded phases
PHASES = set((sys.argv[2] if len(sys.argv) > 2
              else "q3_mem,q3_grace,hc_mem,hc_ext").split(","))

log = lambda m: print(m, file=sys.stderr, flush=True)
emit = lambda d: print(json.dumps(d), flush=True)


def checksum(block):
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
            acc = acc + jnp.sum(
                jnp.where(mask, d.astype(jnp.float64), 0.0)
                * (2.0 ** 20)).astype(jnp.int64)
            continue
        acc = acc + jnp.sum(jnp.where(mask, d.astype(jnp.int64), 0))
    return int(acc)


def timed_run(tag, plan, blocks, settings):
    t0 = time.time()
    out, summary = QueryRunner(plan, settings=settings).run(blocks)
    jax.block_until_ready(out)
    cs = checksum(out)
    dt = time.time() - t0
    ooc = ("grace" in summary.plan_text or "out-of-core" in
           summary.plan_text or "external" in summary.plan_text)
    emit({"phase": tag, "wall_s": round(dt, 2), "checksum": cs,
          "out_of_core": ooc, "sf": SF})
    return cs


def main():
    t0 = time.time()
    cat = generate_tpch(
        sf=SF, seed=7, tables=["lineitem", "orders", "customer"],
        column_subset={
            "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                         "l_shipdate"],
            "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                       "o_shippriority"],
            "customer": ["c_custkey", "c_mktsegment"],
        })
    rows = cat["lineitem"].row_count
    log(f"host gen done sf{SF:g} ({rows} lineitem rows) "
        f"{time.time()-t0:.1f}s; staging to device...")
    blocks = cat.blocks()
    jax.block_until_ready(blocks)
    log(f"gen+stage sf{SF:g} {time.time()-t0:.1f}s")
    spill_dir = tempfile.mkdtemp(prefix="sf10_spill_")

    # ---- phase 1: Q3 shape ------------------------------------------
    from tiflash_jax.bench.tpch_queries import q3_plan
    from tiflash_jax.plan.auto import autosize_plan

    cs_mem = None
    if "q3_mem" in PHASES:
        plan = q3_plan()
        autosize_plan(plan, blocks)
        cs_mem = timed_run("q3_in_memory", plan, blocks, Settings())

    if "q3_grace" in PHASES:
        plan2 = q3_plan()
        autosize_plan(plan2, blocks)
        s = Settings(max_bytes_before_external_join=1,
                     spill_dir=spill_dir)
        cs_grace = timed_run("q3_grace_join", plan2, blocks, s)
        if cs_mem is not None:
            assert cs_grace == cs_mem, (cs_grace, cs_mem)
            emit({"phase": "q3_parity", "equal": True})

    # ---- phase 2: high-cardinality group-by -------------------------
    # group by l_orderkey: SF x 1.5M distinct groups over SF x 6M rows
    hc = P.Aggregation(
        ["l_orderkey"],
        [AggDesc("sum", "l_extendedprice", "s"),
         AggDesc("count", None, "c")],
        P.Selection(col("l_shipdate") > "1995-03-15",
                    P.TableScan("lineitem",
                                columns=["l_orderkey", "l_extendedprice",
                                         "l_shipdate"])))
    autosize_plan(hc, blocks)
    cs_agg = None
    if "hc_mem" in PHASES:
        cs_agg = timed_run("hc_groupby_in_memory", hc, blocks, Settings())
    if "hc_ext" not in PHASES:
        emit({"phase": "done", "total_wall_s": round(time.time() - t0, 1)})
        return

    hc2 = P.Aggregation(
        ["l_orderkey"],
        [AggDesc("sum", "l_extendedprice", "s"),
         AggDesc("count", None, "c")],
        P.Selection(col("l_shipdate") > "1995-03-15",
                    P.TableScan("lineitem",
                                columns=["l_orderkey", "l_extendedprice",
                                         "l_shipdate"])))
    autosize_plan(hc2, blocks)
    s2 = Settings(max_bytes_before_external_group_by=1,
                  spill_dir=spill_dir)
    cs_ext = timed_run("hc_groupby_external", hc2, blocks, s2)
    if cs_agg is not None:
        assert cs_ext == cs_agg, (cs_ext, cs_agg)
        emit({"phase": "hc_parity", "equal": True})
    emit({"phase": "done", "total_wall_s": round(time.time() - t0, 1)})


if __name__ == "__main__":
    main()
