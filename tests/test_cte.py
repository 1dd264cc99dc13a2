"""CTE tests: one materialization, many consumers (CTESink/Source analog)."""

import jax
import numpy as np
from jax.sharding import Mesh

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import col
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle


def setup(seed=0, n=120):
    rng = np.random.default_rng(seed)
    schema = {"k": dt.INT32, "v": dt.INT64}
    t = O.random_pytable(rng, n, schema, null_prob=0, int_range=(0, 9))
    return t, {"t": O.pytable_to_block(t, schema)}


def test_cte_joined_with_itself():
    t, blocks = setup()
    cte = P.Selection(col("v") > 10, P.TableScan("t"))
    plan = P.WithCTE(
        {"c": cte},
        P.Join(
            kind="inner", probe_keys=["k"], build_keys=["k"],
            probe=P.CTERef("c"), build=P.CTERef("c"), output_capacity=8192,
        ),
    )
    out, ov = compile_fragment(plan)(blocks)
    assert all(int(np.asarray(v)) == 0 for v in ov.values())
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, {"t": t})
    O.assert_tables_equal(got, want)


def test_cte_multiple_consumers_aggregate():
    t, blocks = setup(seed=1)
    plan = P.WithCTE(
        {"c": P.Projection({"k": col("k"), "v2": col("v") * 2}, P.TableScan("t"))},
        P.Join(
            kind="left",
            probe_keys=["k"],
            build_keys=["k"],
            probe=P.Aggregation(["k"], [AggDesc("sum", "v2", "s")], P.CTERef("c")),
            build=P.Aggregation(["k"], [AggDesc("count", None, "c")], P.CTERef("c")),
            unique_build=True,
        ),
    )
    out, _ = compile_fragment(plan)(blocks)
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, {"t": t})
    O.assert_tables_equal(got, want)


def test_cte_distributed():
    from tiflash_jax.runtime.executor import run_query

    t, blocks = setup(seed=2, n=320)
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    plan = P.WithCTE(
        {"c": P.Selection(col("v") > 0, P.TableScan("t"))},
        P.ExchangeReceiver(P.ExchangeSender("hash", ["k"], P.CTERef("c"))),
    )
    out, _ = run_query(plan, blocks, mesh=mesh)
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, {"t": t})
    O.assert_tables_equal(got, want)
