"""Distributed (SPMD) execution tests on a virtual 8-device CPU mesh.

Role analog: ``Flash/tests/gtest_compute_server.cpp`` — multi-node MPP
joins/aggs without a real cluster.  Here: shard_map over 8 host devices,
collectives instead of gRPC, results must match the single-table oracle
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import col, lit
from tiflash_jax.mpp.runner import (
    ExchangeConfig,
    collect_result,
    compile_distributed,
    shard_catalog_blocks,
)
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.distribute import (
    broadcast_join,
    gather_topn,
    shuffle_join,
    split_aggregation,
)
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8, "conftest must provide 8 cpu devices"
    return Mesh(devs, ("d",))


def make_tables(mesh, seed=0, n=640):
    rng = np.random.default_rng(seed)
    schema = {
        "k": dt.INT32,
        "k2": dt.STRING,
        "v": dt.Decimal(10, 2, nullable=True),
        "w": dt.INT64,
    }
    t = O.random_pytable(rng, n, schema, int_range=(0, 37))
    b = O.pytable_to_block(t, schema)
    blocks = shard_catalog_blocks({"t": b}, mesh)
    return t, blocks


def run_dist(plan, mesh, blocks, **cfg_kw):
    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(**cfg_kw))
    out, overflows = fn(blocks)
    for k, v in overflows.items():
        assert not bool(np.asarray(v).max()), f"overflow at {k}"
    return O.block_to_pytable(collect_result(out))


def test_distributed_aggregation(mesh):
    t, blocks = make_tables(mesh, seed=1)
    aggs = [
        AggDesc("sum", "v", "s"),
        AggDesc("count", None, "c"),
        AggDesc("count", "v", "cv"),
        AggDesc("min", "w", "mn"),
        AggDesc("max", "w", "mx"),
        AggDesc("avg", "v", "a"),
    ]
    plan = split_aggregation(["k"], aggs, P.TableScan("t"))
    got = run_dist(plan, mesh, blocks)
    want = O.o_aggregate(t, ["k"], [(a.func, a.arg, a.name) for a in aggs])
    O.assert_tables_equal(got, want)


def test_distributed_agg_string_key(mesh):
    t, blocks = make_tables(mesh, seed=2)
    aggs = [AggDesc("sum", "w", "s"), AggDesc("count", None, "c")]
    plan = split_aggregation(["k2"], aggs, P.TableScan("t"))
    got = run_dist(plan, mesh, blocks)
    want = O.o_aggregate(t, ["k2"], [("sum", "w", "s"), ("count", None, "c")])
    O.assert_tables_equal(got, want)


def make_join_tables(mesh, seed=3, nl=600, nr=200):
    rng = np.random.default_rng(seed)
    ls = {"lk": dt.INT32.with_nullable(True), "lv": dt.INT64}
    rs = {"rk": dt.INT32.with_nullable(True), "rv": dt.INT64}
    lt = O.random_pytable(rng, nl, ls, int_range=(0, 50))
    rt = O.random_pytable(rng, nr, rs, int_range=(0, 50))
    blocks = shard_catalog_blocks(
        {"l": O.pytable_to_block(lt, ls), "r": O.pytable_to_block(rt, rs)}, mesh
    )
    return lt, rt, blocks


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_distributed_shuffle_join(mesh, kind):
    lt, rt, blocks = make_join_tables(mesh)
    plan = shuffle_join(
        kind, ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=8192,
    )
    got = run_dist(plan, mesh, blocks, shuffle_factor=8.0)
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(got, want)


def test_distributed_broadcast_join(mesh):
    lt, rt, blocks = make_join_tables(mesh, seed=4)
    plan = broadcast_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=8192,
    )
    got = run_dist(plan, mesh, blocks)
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_distributed_gather_topn(mesh):
    t, blocks = make_tables(mesh, seed=5)
    plan = gather_topn([SortKey("w", desc=True, nulls_first=False)], 15, P.TableScan("t"))
    got = run_dist(plan, mesh, blocks)
    want = O.o_sort(t, [("w", True)], limit=15)
    assert sorted(got["w"]) == sorted(want["w"])


def test_distributed_join_then_agg(mesh):
    """Q3-shaped: shuffle join then distributed group-by on top."""
    lt, rt, blocks = make_join_tables(mesh, seed=6)
    j = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=8192,
    )
    plan = split_aggregation(
        ["rk"], [AggDesc("sum", "lv", "s"), AggDesc("count", None, "c")], j
    )
    got = run_dist(plan, mesh, blocks, shuffle_factor=8.0)
    jt = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    want = O.o_aggregate(jt, ["rk"], [("sum", "lv", "s"), ("count", None, "c")])
    O.assert_tables_equal(got, want)


def test_shuffle_overflow_detected(mesh):
    # all rows share one key -> everything lands on one partition; with a
    # sub-1.0 factor the per-chunk capacity must overflow and be reported
    schema = {"k": dt.INT32, "v": dt.INT64}
    t = {"k": [7] * 640, "v": list(range(640))}
    blocks = shard_catalog_blocks({"t": O.pytable_to_block(t, schema)}, mesh)
    plan = P.ExchangeReceiver(P.ExchangeSender("hash", ["k"], P.TableScan("t")))
    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(shuffle_factor=0.5))
    _, overflows = fn(blocks)
    assert any(bool(np.asarray(v).max()) for v in overflows.values())


def test_shuffle_join_with_runtime_filter(mesh):
    """Runtime filter: build min/max prunes probe rows pre-exchange;
    results must be identical to the unfiltered join."""
    lt, rt, blocks = make_join_tables(mesh, seed=11)
    from tiflash_jax.plan.distribute import shuffle_join

    plan = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=8192, runtime_filter=True,
    )
    got = run_dist(plan, mesh, blocks, shuffle_factor=8.0)
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_runtime_filter_actually_prunes(mesh):
    """With a narrow build key range, the probe exchange should carry far
    fewer rows (observable via a small shuffle capacity that would
    overflow without the filter)."""
    import tiflash_jax.core.dtypes as dtt

    lt = {"lk": list(range(640)), "lv": [1] * 640}
    rt = {"rk": [10, 11, 12], "rv": [7, 8, 9]}
    blocks = shard_catalog_blocks(
        {
            "l": O.pytable_to_block(lt, {"lk": dtt.INT32, "lv": dtt.INT64}),
            "r": O.pytable_to_block(rt, {"rk": dtt.INT32, "rv": dtt.INT64}),
        },
        mesh,
    )
    from tiflash_jax.plan.distribute import shuffle_join

    # capacity too small for 640 rows but plenty for the ~3 surviving ones
    plan = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=512, runtime_filter=True,
    )
    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(shuffle_factor=8.0))
    out, overflows = fn(blocks)
    assert not any(bool(np.asarray(v).max()) for v in overflows.values())
    got = O.block_to_pytable(collect_result(out))
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_runtime_filter_in_set_prunes_gaps(mesh):
    """IN-set runtime filter: build keys {5, 600} — min/max alone keeps
    every probe row in [5, 600]; the sorted-set membership must prune the
    gap so a tiny exchange capacity survives (DataStreams/RuntimeFilter.h
    IN type analog)."""
    import tiflash_jax.core.dtypes as dtt

    lt = {"lk": list(range(640)), "lv": [1] * 640}
    rt = {"rk": [5, 600], "rv": [7, 8]}
    blocks = shard_catalog_blocks(
        {
            "l": O.pytable_to_block(lt, {"lk": dtt.INT32, "lv": dtt.INT64}),
            "r": O.pytable_to_block(rt, {"rk": dtt.INT32, "rv": dtt.INT64}),
        },
        mesh,
    )
    from tiflash_jax.plan.distribute import shuffle_join

    # 640 in-range rows would overflow; only 2 survive the IN-set
    plan = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=256, runtime_filter=True,
    )
    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(shuffle_factor=0.25))
    out, overflows = fn(blocks)
    assert not any(bool(np.asarray(v).max()) for v in overflows.values())
    got = O.block_to_pytable(collect_result(out))
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_runtime_filter_in_set_respects_size_gate(mesh):
    """Builds larger than rf_in_set_max_build publish min/max only —
    results stay correct (the set is an optimization, never semantics)."""
    lt, rt, blocks = make_join_tables(mesh, seed=13)
    from tiflash_jax.plan.distribute import shuffle_join

    plan = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=8192, runtime_filter=True,
    )
    got = run_dist(plan, mesh, blocks, shuffle_factor=8.0,
                   rf_in_set_max_build=1)
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_distributed_group_concat_distinct(mesh):
    """DISTINCT/-If group_concat distributes via the co-located shuffle
    (whole groups land on one device; the full aggregation runs locally)."""
    rng = np.random.default_rng(9)
    schema = {"k": dt.INT32, "s": dt.STRING.with_nullable(True),
              "f": dt.BOOL}
    t = O.random_pytable(rng, 480, schema, int_range=(0, 11))
    blocks = shard_catalog_blocks({"t": O.pytable_to_block(t, schema)}, mesh)
    aggs = [AggDesc("group_concat", "s", "gd", distinct=True),
            AggDesc("group_concat", "s", "gf", filter_col="f")]
    # two in-sort-ordered group_concats cannot share one aggregation:
    # run them as separate plans
    for a in aggs:
        plan = split_aggregation(["k"], [a], P.TableScan("t"))
        got = run_dist(plan, mesh, blocks)
        want = O.o_aggregate(
            t, ["k"],
            [("group_concat", "s", a.name, a.filter_col, None, ",",
              a.distinct)],
        )
        O.assert_tables_equal(got, want)


def test_arg_split_count_distinct_two_keys_all_devices(mesh):
    """VERDICT r3 item 6: with only TWO distinct group keys on 8
    devices, COUNT(DISTINCT) must not idle six devices.  The arg-split
    path hashes raw rows on (key, arg) — every device partial-counts a
    disjoint arg shard — and the final stage sums the partial distinct
    counts.  Parity vs the row-at-a-time oracle; the plan shape proves
    the exchange fans out on the argument."""
    rng = np.random.default_rng(9)
    n = 800
    t = {"k": [int(x) for x in rng.integers(0, 2, n)],        # 2 keys!
         "v": [int(x) for x in rng.integers(0, 200, n)],
         "w": [int(x) for x in rng.integers(0, 50, n)]}
    sch = {"k": dt.INT32, "v": dt.INT64, "w": dt.INT64}
    blocks = shard_catalog_blocks({"t": O.pytable_to_block(t, sch)}, mesh)
    aggs = [AggDesc("count_distinct", "v", "ndv"),
            AggDesc("sum", "w", "s"),
            AggDesc("min", "w", "mn")]
    plan = split_aggregation(["k"], aggs, P.TableScan("t"))
    # the first exchange must hash on the distinct ARG too
    txt = plan.pretty()
    assert "v" in txt and "partial" in txt.lower(), txt
    got = run_dist(plan, mesh, blocks, shuffle_factor=4.0)
    want = O.o_aggregate(t, ["k"], [("count_distinct", "v", "ndv"),
                                    ("sum", "w", "s"), ("min", "w", "mn")])
    O.assert_tables_equal(got, want)


def test_arg_split_count_distinct_scalar(mesh):
    """Scalar COUNT(DISTINCT) (no group keys): same arg-split fan-out."""
    rng = np.random.default_rng(11)
    t = {"v": [int(x) for x in rng.integers(0, 300, 600)]}
    sch = {"v": dt.INT64}
    blocks = shard_catalog_blocks({"t": O.pytable_to_block(t, sch)}, mesh)
    plan = split_aggregation([], [AggDesc("count_distinct", "v", "ndv")],
                             P.TableScan("t"))
    got = run_dist(plan, mesh, blocks, shuffle_factor=4.0)
    assert got["ndv"] == [len(set(t["v"]))]
