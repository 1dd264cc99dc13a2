"""tiflash-jax walkthrough: load data, run queries, go distributed.

Runs on a virtual 8-device CPU mesh:  python examples/demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

# the demo runs on a virtual 8-device CPU mesh
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import tiflash_jax  # noqa: F401  (enables x64)
from tiflash_jax.bench.tpch_queries import q1_plan, q3_plan
from tiflash_jax.expr.nodes import col, lit
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.auto import distribute_plan
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.storage.tpch import generate_tpch

print("== 1. generate a TPC-H catalog ==")
cat = generate_tpch(sf=0.01, seed=0)
for name, t in cat.tables.items():
    print(f"   {name:10s} {t.row_count:>8} rows")

print("\n== 2. run TPC-H Q1 on one device ==")
out, summary = run_query(q1_plan(), cat.blocks())
for row in zip(*out.to_pylists().values()):
    print("  ", row[:4], "...")
print("   ", summary.pretty().splitlines()[0])

print("\n== 3. build a custom plan ==")
plan = P.TopN(
    sort_keys=[__import__("tiflash_jax.ops.sort", fromlist=["SortKey"]).SortKey("revenue", desc=True, nulls_first=False)],
    limit=5,
    child=P.Aggregation(
        keys=["l_shipmode"],
        aggs=[AggDesc("sum", "disc_rev", "revenue"),
              AggDesc("count", None, "n")],
        child=P.Projection(
            {"l_shipmode": col("l_shipmode"),
             "disc_rev": col("l_extendedprice") * (lit(1.0) - col("l_discount"))},
            P.Selection(col("l_shipdate") >= "1995-01-01", P.TableScan("lineitem")),
        ),
    ),
)
out, _ = run_query(plan, cat.blocks())
print("   revenue by ship mode:", out.to_pylists())

print("\n== 4. distribute automatically over the device mesh ==")
from jax.sharding import Mesh

mesh = Mesh(np.array(jax.devices()), ("d",))
stats = {n: t.row_count for n, t in cat.tables.items()}
dist = distribute_plan(q3_plan(), stats, len(jax.devices()))
out, summary = run_query(dist, cat.blocks(), mesh=mesh)
print("   Q3 top rows:", out.to_pylists()["l_orderkey"][:5])
print("   ", summary.pretty().splitlines()[0])

print("\n== 5. EXPLAIN ==")
print(dist.pretty())
