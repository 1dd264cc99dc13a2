"""Out-of-core grace join + external sort (VERDICT round-1 item 4).

Role analog: ``Interpreters/Join.h:95-100`` restore rounds and
``Interpreters/SortSpillContext.h`` — here host-partitioned grace rounds
with exact parity against the in-memory run and the python oracle.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.bench.tpch_queries import q3_plan
from tiflash_jax.expr.nodes import col
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.runtime.outofcore import grace_spec, sliced_spec
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.storage.tpch import generate_tpch
from tiflash_jax.testing import oracle as O


@pytest.fixture(scope="module")
def cat():
    return generate_tpch(sf=0.005, seed=11,
                         tables=["lineitem", "orders", "customer"])


def test_q3_shaped_grace_join(cat):
    """The VERDICT done-criterion: a Q3-shaped join over tables exceeding
    max_bytes_per_device passes parity with the in-memory run."""
    plan = q3_plan()
    blocks = cat.blocks()
    full, _ = run_query(plan, blocks)
    tiny = Settings(max_bytes_per_device=1 << 19)  # 512 KiB: forces grace
    oc, summary = run_query(q3_plan(), blocks, settings=tiny)
    assert "grace out-of-core" in summary.plan_text
    O.assert_tables_equal(
        O.block_to_pytable(oc), O.block_to_pytable(full.compact())
    )


def _join_tables(seed=3, nl=3000, nr=800):
    rng = np.random.default_rng(seed)
    ls = {"lk": dt.INT32.with_nullable(True), "lv": dt.INT64}
    rs = {"rk": dt.INT32.with_nullable(True), "rv": dt.INT64}
    lt = O.random_pytable(rng, nl, ls, int_range=(0, 200))
    rt = O.random_pytable(rng, nr, rs, int_range=(0, 200))
    blocks = {"l": O.pytable_to_block(lt, ls), "r": O.pytable_to_block(rt, rs)}
    return lt, rt, blocks


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_grace_join_replicated_build_oracle(kind):
    """Big probe, small replicated build: oracle parity per join kind."""
    lt, rt, blocks = _join_tables()
    plan = P.Join(kind=kind, probe_keys=["lk"], build_keys=["rk"],
                  probe=P.TableScan("l"), build=P.TableScan("r"),
                  output_capacity=8192)
    tiny = Settings(max_bytes_per_device=1 << 17)
    out, summary = run_query(plan, blocks, settings=tiny)
    assert "grace out-of-core" in summary.plan_text
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(O.block_to_pytable(out), want)


@pytest.mark.parametrize("kind", ["inner", "right_outer"])
def test_grace_join_copartitioned_oracle(kind):
    """Both sides partitioned (build exceeds the budget too) — incl. a
    build-tail kind (right_outer) whose non-matched scan must stay
    partition-local."""
    lt, rt, blocks = _join_tables(seed=4, nl=2500, nr=2500)
    plan = P.Join(kind=kind, probe_keys=["lk"], build_keys=["rk"],
                  probe=P.TableScan("l"), build=P.TableScan("r"),
                  output_capacity=16384)
    tiny = Settings(max_bytes_per_device=1 << 15)  # 32 KiB: build too big
    out, summary = run_query(plan, blocks, settings=tiny)
    assert "grace out-of-core" in summary.plan_text
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(O.block_to_pytable(out), want)


def test_grace_spec_rejects_null_aware():
    plan = P.Join(kind="anti_null_aware", probe_keys=["lk"],
                  build_keys=["rk"], probe=P.TableScan("l"),
                  build=P.TableScan("r"))
    assert grace_spec(plan) is None


def test_external_sort_and_topn(cat):
    """Sort/TopN over a table exceeding the budget: chunk-sorted runs +
    merge pass equal the in-memory result."""
    li = P.TableScan("lineitem",
                     columns=["l_orderkey", "l_extendedprice", "l_shipdate"])
    sort_plan = P.Sort([SortKey("l_extendedprice", desc=True),
                        SortKey("l_orderkey")], li)
    blocks = cat.blocks()
    full, _ = run_query(sort_plan, blocks)
    tiny = Settings(max_bytes_per_device=1 << 19)
    assert sliced_spec(sort_plan) is not None
    oc, summary = run_query(sort_plan, blocks, settings=tiny)
    assert "sliced out-of-core" in summary.plan_text
    fa, fb = O.block_to_pytable(full.compact()), O.block_to_pytable(oc)
    O.assert_tables_equal(fb, fa)

    topn_plan = P.TopN([SortKey("l_extendedprice", desc=True),
                        SortKey("l_orderkey")], 25, li)
    full_t, _ = run_query(topn_plan, blocks)
    oc_t, summary = run_query(topn_plan, blocks, settings=tiny)
    assert "sliced out-of-core" in summary.plan_text
    O.assert_tables_equal(
        O.block_to_pytable(oc_t), O.block_to_pytable(full_t.compact()),
        ordered=True,
    )


def test_grace_join_adaptive_repartition():
    """Skewed (but distinct) keys concentrate under a small P: the
    partitioner widens P until the largest partition fits its share
    (the restore-round analog, collapsed into host re-hashing)."""
    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.outofcore import run_grace_join
    from tiflash_jax.testing import oracle as O

    rng = np.random.default_rng(31)
    n, m = 20_000, 50
    # keys clustered mod small values: collide badly at tiny P
    lt = {"fk": [int(x) * 256 for x in rng.integers(0, m, n)],
          "v": [int(x) for x in rng.integers(0, 100, n)]}
    rt = {"pk": [k * 256 for k in range(m)],
          "w": [int(x) for x in rng.integers(0, 9, m)]}
    lsch = {"fk": dt.INT64, "v": dt.INT64}
    rsch = {"pk": dt.INT64, "w": dt.INT64}
    plan = P.Aggregation(
        ["fk"], [AggDesc("sum", "w", "s"), AggDesc("count", None, "c")],
        P.Join(kind="inner", probe_keys=["fk"], build_keys=["pk"],
               probe=P.TableScan("L"), build=P.TableScan("R"),
               unique_build=True),
    )
    tables = {"L": O.pytable_to_block(lt, lsch), "R": O.pytable_to_block(rt, rsch)}
    out = run_grace_join(plan, tables, budget_bytes=200_000)
    got = O.sort_pytable(O.block_to_pytable(out.compact()))
    want = O.sort_pytable(O.o_aggregate(
        O.o_join(lt, rt, ["fk"], ["pk"], "inner"),
        ["fk"], [("sum", "w", "s"), ("count", None, "c")]))
    O.assert_tables_equal(got, want, ordered=True)
