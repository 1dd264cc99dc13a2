"""Runtime layer tests: QueryRunner retries, failpoints, metrics,
summaries (the fault-inject tier of the reference's test strategy)."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import col
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.distribute import shuffle_join, split_aggregation
from tiflash_jax.runtime.executor import QueryRunner, enumerate_plan, run_query
from tiflash_jax.runtime.failpoint import FailPoint, FailPointError, fail_point
from tiflash_jax.runtime.metrics import METRICS
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.testing import oracle as O


@pytest.fixture(autouse=True)
def clean_failpoints():
    yield
    FailPoint.disable_all()


def make_join_setup(nl=400, nr=100, hot=False, seed=0):
    rng = np.random.default_rng(seed)
    ls = {"lk": dt.INT32, "lv": dt.INT64}
    rs = {"rk": dt.INT32, "rv": dt.INT64}
    lt = O.random_pytable(rng, nl, ls, null_prob=0, int_range=(0, 30))
    rt = O.random_pytable(rng, nr, rs, null_prob=0, int_range=(0, 30))
    if hot:  # every build row matches every 5th probe row -> big expansion
        lt["lk"] = [5] * nl
        rt["rk"] = [5] * nr
    return lt, rt, {
        "l": O.pytable_to_block(lt, ls),
        "r": O.pytable_to_block(rt, rs),
    }


def test_retry_grows_join_capacity():
    lt, rt, blocks = make_join_setup(nl=64, nr=32, hot=True)
    plan = P.Join(
        kind="inner", probe_keys=["lk"], build_keys=["rk"],
        probe=P.TableScan("l"), build=P.TableScan("r"),
        output_capacity=64,  # true size 64*32=2048 -> needs retries
    )
    out, summary = run_query(plan, blocks)
    assert summary.retries >= 1
    got = O.block_to_pytable(out)
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_retry_exhaustion_raises():
    lt, rt, blocks = make_join_setup(nl=64, nr=32, hot=True)
    plan = P.Join(
        kind="inner", probe_keys=["lk"], build_keys=["rk"],
        probe=P.TableScan("l"), build=P.TableScan("r"), output_capacity=1,
    )
    with pytest.raises(RuntimeError, match="overflow persisted"):
        run_query(plan, blocks, settings=Settings(max_capacity_retries=0))


def test_distributed_retry_grows_shuffle():
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    t = {"k": [3] * 800, "v": list(range(800))}
    schema = {"k": dt.INT32, "v": dt.INT64}
    blocks = {"t": O.pytable_to_block(t, schema)}
    plan = split_aggregation(
        ["k"], [AggDesc("sum", "v", "s")], P.TableScan("t"), partial_slots=None
    )
    # all rows on one key: every partial lands on one device; small factor
    # forces at least one retry of the exchange
    out, summary = run_query(
        plan, blocks, mesh=mesh,
        settings=Settings(default_shuffle_factor=0.25, max_capacity_retries=6),
    )
    got = O.block_to_pytable(out)
    want = O.o_aggregate(t, ["k"], [("sum", "v", "s")])
    O.assert_tables_equal(got, want)


def test_failpoint_triggers():
    FailPoint.enable("exception_before_fragment_run")
    lt, rt, blocks = make_join_setup()
    plan = P.TableScan("l")
    with pytest.raises(FailPointError):
        run_query(plan, blocks)


def test_failpoint_probabilistic():
    FailPoint.enable("random_fragment_failure", probability=1.0)
    with pytest.raises(FailPointError):
        fail_point("random_fragment_failure")
    FailPoint.enable("random_fragment_failure", probability=0.0)
    fail_point("random_fragment_failure")  # never fires


def test_summary_and_metrics():
    before = METRICS.dump()["queries_total"]
    lt, rt, blocks = make_join_setup()
    plan = P.Selection(col("lv") > 0, P.TableScan("l"))
    out, summary = run_query(plan, blocks)
    assert summary.result_rows == sum(1 for v in lt["lv"] if v > 0)
    assert summary.wall_seconds > 0
    assert "Selection" in summary.plan_text
    assert METRICS.dump()["queries_total"] == before + 1
    assert summary.to_json()


def test_enumerate_plan_matches_executor_ids():
    """enumerate_plan must assign exactly the ids the executors emit in
    overflow keys."""
    plan = split_aggregation(
        ["rk"], [AggDesc("sum", "lv", "s")],
        shuffle_join(
            "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
            output_capacity=8,
        ),
    )
    nodes, exchanges = enumerate_plan(plan)
    agg_ids = [i for i, n in nodes.items() if isinstance(n, P.Aggregation)]
    join_ids = [i for i, n in nodes.items() if isinstance(n, P.Join)]
    assert len(agg_ids) == 2 and len(join_ids) == 1 and len(exchanges) == 3

    # run distributed with forced overflow to cross-check key ids
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    rng = np.random.default_rng(1)
    ls = {"lk": dt.INT32, "lv": dt.INT64}
    rs = {"rk": dt.INT32, "rv": dt.INT64}
    lt = O.random_pytable(rng, 160, ls, null_prob=0, int_range=(0, 4))
    rt = O.random_pytable(rng, 80, rs, null_prob=0, int_range=(0, 4))
    blocks = {"l": O.pytable_to_block(lt, ls), "r": O.pytable_to_block(rt, rs)}
    rng2 = np.random.default_rng(2)
    lt2 = {"k": lt["lk"], "v": lt["lv"]}
    from tiflash_jax.mpp.runner import compile_distributed, shard_catalog_blocks, ExchangeConfig

    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(shuffle_factor=4.0))
    sharded = shard_catalog_blocks(blocks, mesh)
    _, overflows = fn(sharded)
    for key in overflows:
        kind, _, sid = key.rpartition("_")
        nid = int(sid)
        if kind == "Exchange":
            assert nid in exchanges, (key, list(exchanges))
        else:
            assert nid in nodes and type(nodes[nid]).__name__ == kind, (key,)


def test_summary_node_rows_explain_analyze():
    """EXPLAIN ANALYZE: per-node live-row counts in the summary."""
    lt, rt, blocks = make_join_setup(nl=100, nr=40)
    plan = P.Selection(col("lv") > 0, P.TableScan("l"))
    out, summary = run_query(plan, blocks)
    assert summary.node_rows.get("TableScan_2") == 100
    sel_rows = summary.node_rows.get("Selection_1")
    assert sel_rows == summary.result_rows


def test_explain_analyze_per_operator_times():
    """Per-node subtree/self timings (ExecutorStatisticsCollector.h:38
    analog, via subtree differencing — runtime/analyze.py)."""
    from tiflash_jax.runtime.analyze import explain_analyze, format_analyze
    from tiflash_jax.ops.sort import SortKey

    rng = np.random.default_rng(3)
    n = 4096
    table = {"k": rng.integers(0, 9, n).tolist(),
             "v": rng.integers(0, 100, n).tolist()}
    blocks = {"t": O.pytable_to_block(table, {"k": dt.INT32, "v": dt.INT64})}
    plan = P.TopN(
        [SortKey("s", desc=True)], 3,
        P.Aggregation(keys=["k"], aggs=[AggDesc("sum", "v", "s")],
                      child=P.Selection(col("v") > 10, P.TableScan("t"))),
    )
    report = explain_analyze(plan, blocks, k1=1, k2=3)
    ops = [r["operator"] for r in report]
    assert ops == ["TopN", "Aggregation", "Selection", "TableScan"]
    for r in report:
        assert r["subtree_s"] is not None and r["subtree_s"] >= 0
        assert r["self_s"] is not None and r["self_s"] >= 0
    # self times telescope to at least the root's subtree time (clamping
    # at 0 can only push the sum up; exact equality is noise-sensitive)
    total_self = sum(r["self_s"] for r in report)
    assert total_self >= report[0]["subtree_s"] - 1e-6
    text = format_analyze(report)
    assert "Aggregation" in text and "ms" in text


def test_plan_chunk_rows_uses_real_row_width():
    """Chunk sizing must reflect actual column widths, not a flat
    bytes-per-row constant: a 2x-wider scan halves the chunk rows."""
    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.memory import plan_chunk_rows
    from tiflash_jax.testing import oracle as O
    import numpy as np

    rng = np.random.default_rng(0)
    narrow_schema = {"a": dt.INT64}
    wide_schema = {c: dt.INT64 for c in "abcdefgh"}
    narrow = O.pytable_to_block(O.random_pytable(rng, 256, narrow_schema),
                                narrow_schema)
    wide = O.pytable_to_block(O.random_pytable(rng, 256, wide_schema),
                              wide_schema)
    budget = 1 << 26
    rows_narrow = plan_chunk_rows(P.TableScan("t"), {"t": narrow}, budget)
    rows_wide = plan_chunk_rows(P.TableScan("t"), {"t": wide}, budget)
    assert rows_wide < rows_narrow
    assert rows_narrow == budget // (8 * 8)
    # column pruning: scanning one column of the wide table = narrow cost
    pruned = plan_chunk_rows(P.TableScan("t", columns=["a"]),
                             {"t": wide}, budget)
    assert pruned == rows_narrow


def test_query_memory_scope_and_summary_fields():
    """Runtime memory accounting (MemoryTracker live-byte counters):
    summary carries allocator peak/delta; CPU backends degrade to 0."""
    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.memory import QueryMemoryScope, device_memory_stats
    from tiflash_jax.testing import oracle as O

    stats = device_memory_stats()
    assert isinstance(stats, dict)
    with QueryMemoryScope() as mem:
        pass
    assert mem.peak_bytes >= 0 and isinstance(mem.delta_bytes, int)

    schema = {"k": dt.INT32, "v": dt.INT64}
    rng = np.random.default_rng(5)
    table = O.random_pytable(rng, 64, schema, null_prob=0.0, int_range=(0, 4))
    block = O.pytable_to_block(table, schema)
    plan = P.Aggregation(["k"], [AggDesc("sum", "v", "sv")], P.TableScan("t"))
    out, summary = QueryRunner(plan).run({"t": block})
    assert summary.peak_device_bytes >= 0
    assert hasattr(summary, "device_bytes_delta")
