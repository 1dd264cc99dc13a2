"""Expand (grouping sets), cross join, null-aware anti join, and
auto-passthrough aggregation parity tests."""

import jax.numpy as jnp
import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.ops.aggregate import AggDesc, auto_passthrough_aggregate
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle


def tables_for(schemas, seed=0, n=200, **kw):
    rng = np.random.default_rng(seed)
    pts, blocks = {}, {}
    for name, schema in schemas.items():
        t = O.random_pytable(rng, n, schema, **kw)
        pts[name] = t
        blocks[name] = O.pytable_to_block(t, schema)
    return pts, blocks


def check_plan(plan, pts, blocks, ordered=False):
    out, ov = compile_fragment(plan)(blocks)
    for k, v in ov.items():
        assert int(np.asarray(v)) == 0, (k, v)
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, pts)
    O.assert_tables_equal(got, want, ordered=ordered)


def test_expand_rollup():
    schema = {"a": dt.STRING, "b": dt.INT32, "v": dt.INT64}
    pts, blocks = tables_for({"t": schema}, n=100, null_prob=0)
    # ROLLUP(a, b) = grouping sets {(a,b), (a), ()}
    plan = P.Expand([["a", "b"], ["a"], []], P.TableScan("t"))
    check_plan(plan, pts, blocks)


def test_expand_then_aggregate():
    schema = {"a": dt.STRING, "b": dt.INT32.with_nullable(True), "v": dt.INT64}
    pts, blocks = tables_for({"t": schema}, n=150, int_range=(0, 5))
    plan = P.Aggregation(
        keys=["a", "groupingID"],
        aggs=[AggDesc("sum", "v", "s"), AggDesc("count", None, "c")],
        child=P.Expand([["a", "b"], ["a"]], P.TableScan("t")),
    )
    check_plan(plan, pts, blocks)


def test_cross_join():
    pts, blocks = tables_for(
        {"l": {"a": dt.INT32, "v": dt.INT64}, "r": {"b": dt.INT32}},
        n=30, null_prob=0,
    )
    plan = P.CrossJoin(
        probe=P.TableScan("l"), build=P.TableScan("r"), output_capacity=30 * 30
    )
    check_plan(plan, pts, blocks)


def test_cross_join_overflow_retry():
    from tiflash_jax.runtime.executor import run_query

    pts, blocks = tables_for(
        {"l": {"a": dt.INT32}, "r": {"b": dt.INT32}}, n=40, null_prob=0
    )
    plan = P.CrossJoin(probe=P.TableScan("l"), build=P.TableScan("r"),
                       output_capacity=10)
    out, summary = run_query(plan, blocks)
    assert summary.retries >= 1
    assert summary.result_rows == 1600


@pytest.mark.parametrize("with_nulls,empty_build", [
    (True, False), (False, False), (False, True), (True, True),
])
def test_anti_null_aware(with_nulls, empty_build):
    rng = np.random.default_rng(3)
    ls = {"lk": dt.INT32.with_nullable(True), "lv": dt.INT64}
    rs = {"rk": dt.INT32.with_nullable(with_nulls)}
    lt = O.random_pytable(rng, 120, ls, int_range=(0, 20),
                          null_prob=0.2 if with_nulls else 0.0)
    nr = 0 if empty_build else 40
    rt = O.random_pytable(rng, nr, rs, int_range=(0, 20),
                          null_prob=0.2 if with_nulls else 0.0)
    if empty_build:
        rt = {"rk": []}
        # zero-capacity blocks unsupported; emulate empty via all-dead sel
        rt = {"rk": [0] * 4}
        rb = O.pytable_to_block(rt, rs).and_sel(jnp.zeros(4, dtype=bool))
        rt_oracle = {"rk": []}
    else:
        rb = O.pytable_to_block(rt, rs)
        rt_oracle = rt
    lb = O.pytable_to_block(lt, ls)
    from tiflash_jax.ops.join import hash_join

    joined, _ = hash_join(lb, rb, ["lk"], ["rk"], kind="anti_null_aware",
                          output_capacity=512)
    got = O.block_to_pytable(joined)
    want = O.o_anti_null_aware(lt, rt_oracle, ["lk"], ["rk"])
    O.assert_tables_equal(got, want)


def test_auto_passthrough_low_cardinality_aggregates():
    # few keys -> agg branch; result must equal plain aggregation
    rng = np.random.default_rng(4)
    schema = {"k": dt.INT64, "v": dt.INT64}
    t = O.random_pytable(rng, 512, schema, null_prob=0, int_range=(0, 4))
    b = O.pytable_to_block(t, schema)
    res = auto_passthrough_aggregate(b, ["k"], [AggDesc("sum", "v", "s"),
                                               AggDesc("count", None, "c")])
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(t, ["k"], [("sum", "v", "s"), ("count", None, "c")])
    O.assert_tables_equal(got, want)
    assert int(res.num_groups) == len(want["k"])


def test_auto_passthrough_high_cardinality_passes_rows():
    # all-distinct keys -> passthrough branch: rows unreduced
    schema = {"k": dt.INT64, "v": dt.INT64}
    t = {"k": list(range(512)), "v": [1] * 512}
    b = O.pytable_to_block(t, schema)
    res = auto_passthrough_aggregate(b, ["k"], [AggDesc("sum", "v", "s"),
                                               AggDesc("count", None, "c")])
    assert int(res.num_groups) == 512
    got = O.block_to_pytable(res.block)
    # passthrough rows ARE the groups here (one row per key)
    want = O.o_aggregate(t, ["k"], [("sum", "v", "s"), ("count", None, "c")])
    O.assert_tables_equal(got, want)


def test_auto_passthrough_distributed_final_merge():
    """auto partial -> shuffle -> final must equal plain aggregation even
    when passthrough triggers."""
    import jax
    from jax.sharding import Mesh

    from tiflash_jax.plan.distribute import split_aggregation
    from tiflash_jax.runtime.executor import run_query

    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    rng = np.random.default_rng(5)
    schema = {"k": dt.INT64, "v": dt.INT64}
    t = {"k": [int(x) for x in rng.integers(0, 100000, 640)],
         "v": [int(x) for x in rng.integers(0, 100, 640)]}
    blocks = {"t": O.pytable_to_block(t, schema)}
    plan = split_aggregation(
        ["k"], [AggDesc("sum", "v", "s"), AggDesc("avg", "v", "a")],
        P.TableScan("t"), auto_passthrough=True,
    )
    out, _ = run_query(plan, blocks, mesh=mesh)
    got = O.block_to_pytable(out)
    want = O.o_aggregate(t, ["k"], [("sum", "v", "s"), ("avg", "v", "a")])
    O.assert_tables_equal(got, want)
