"""End-to-end TPC-H-style query parity: engine (jitted plan) vs oracle.

Role analog: the reference's fullstack-test TPC-H plans — row-exact
output equality (BASELINE.md parity oracle), here at tiny SF on CPU.
"""

import pytest

from tiflash_jax.bench.tpch_queries import q1_plan, q3_plan, q6_plan, sort_topn_plan
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.storage.tpch import generate_tpch
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle


@pytest.fixture(scope="module")
def data():
    cat = generate_tpch(sf=0.001, seed=7)
    blocks = cat.blocks()
    pytables = {name: O.block_to_pytable(b) for name, b in blocks.items()}
    return blocks, pytables


def run_both(plan, data, ordered):
    blocks, pytables = data
    fn = compile_fragment(plan)
    out, overflows = fn(blocks)
    for k, v in overflows.items():
        assert not bool(v), f"overflow at {k}"
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, pytables)
    O.assert_tables_equal(got, want, ordered=ordered)
    return got


def test_q1(data):
    got = run_both(q1_plan(), data, ordered=True)
    assert len(got["l_returnflag"]) in (3, 4)


def test_q3(data):
    got = run_both(q3_plan(), data, ordered=True)
    assert len(got["l_orderkey"]) <= 10


def test_q6(data):
    run_both(q6_plan(), data, ordered=True)


def test_sort_topn(data):
    run_both(sort_topn_plan(50), data, ordered=True)


def test_plan_pretty(data):
    s = q3_plan().pretty()
    assert "Join" in s and "TopN" in s and "TableScan" in s


def test_union_partition_table_scan(data):
    """UNION ALL of per-partition scans (PartitionTableScan analog)."""
    import tiflash_jax.plan.nodes as P
    from tiflash_jax.expr.nodes import col
    from tiflash_jax.ops.aggregate import AggDesc

    blocks, pytables = data
    # simulate two partitions by scanning lineitem twice with different
    # filters, then aggregating over the union
    p1 = P.Selection(col("l_orderkey") % 2 == 0, P.TableScan("lineitem"))
    p2 = P.Selection(col("l_orderkey") % 2 == 1, P.TableScan("lineitem"))
    plan = P.Aggregation([], [AggDesc("count", None, "n"),
                              AggDesc("sum", "l_quantity", "s")],
                         P.Union([p1, p2]))
    run_both(plan, data, ordered=True)


def test_q3_rewrite_equivalence(data):
    """eager_aggregation rewrite: same rows as the unrewritten plan."""
    blocks, _ = data
    got_rw, ov1 = compile_fragment(q3_plan(rewrite=True))(blocks)
    got_raw, ov2 = compile_fragment(q3_plan(rewrite=False))(blocks)
    for v in list(ov1.values()) + list(ov2.values()):
        assert not bool(v)
    from tiflash_jax.testing import oracle as O

    O.assert_tables_equal(
        O.block_to_pytable(got_rw), O.block_to_pytable(got_raw), ordered=True
    )


def test_q3_rewrite_shape():
    """The aggregation lands below the orders join and streams."""
    s = q3_plan().pretty()
    agg_at = s.index("Aggregation")
    join_at = s.index("Join")
    assert join_at < agg_at, "aggregation should sit under the join"
