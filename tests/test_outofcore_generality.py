"""Out-of-core generality (VERDICT r2 item 10): grace for self-joins /
shared-scan sides, and group-hash partitioned aggregation for
non-decomposable aggregates (count distinct, group_concat, var,
quantile).  Reference: the spiller handles every breaker unconditionally
(Core/Spiller.h:87, Interpreters/Join.h:95-100)."""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import col
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.executor import QueryRunner
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.testing import oracle as O


def _norm(block):
    return O.sort_pytable(O.block_to_pytable(block.compact()))


def test_grace_self_join(tmp_path):
    """Self-join on different columns of the SAME table graces by
    cloning the build-side scan; results match the in-RAM run."""
    rng = np.random.default_rng(23)
    n = 8000
    sch = {"a": dt.INT64, "b": dt.INT64, "v": dt.INT64}
    t = {"a": [int(x) for x in rng.integers(0, 300, n)],
         "b": [int(x) for x in rng.integers(0, 300, n)],
         "v": [int(x) for x in rng.integers(0, 50, n)]}
    blk = O.pytable_to_block(t, sch)
    plan = P.Aggregation(
        ["a"], [AggDesc("sum", "v", "s"), AggDesc("count", None, "c")],
        P.Join(kind="inner", probe_keys=["a"], build_keys=["b"],
               probe=P.TableScan("T"), build=P.TableScan("T"),
               output_capacity=1 << 18))
    ref, _ = QueryRunner(plan, settings=Settings()).run({"T": blk})
    s = Settings(max_bytes_before_external_join=10_000,
                 spill_dir=str(tmp_path))
    got, summary = QueryRunner(plan, settings=s).run({"T": blk})
    assert "grace out-of-core" in summary.plan_text
    O.assert_tables_equal(_norm(got), _norm(ref), ordered=True)


@pytest.mark.parametrize("aggs", [
    [AggDesc("count_distinct", "v", "cd"), AggDesc("sum", "v", "s")],
    [AggDesc("var_pop", "v", "vp"), AggDesc("count", None, "c")],
])
def test_groupagg_partitioned_distinct_and_var(tmp_path, aggs):
    """Non-decomposable aggregates go out-of-core by partitioning on the
    group-key hash (each group is partition-local -> exact)."""
    rng = np.random.default_rng(31)
    n = 20_000
    sch = {"g": dt.INT64, "v": dt.INT64.with_nullable(True)}
    t = {"g": [int(x) for x in rng.integers(0, 97, n)],
         "v": [None if rng.random() < 0.05 else int(rng.integers(0, 40))
               for _ in range(n)]}
    blk = O.pytable_to_block(t, sch)
    plan = P.Aggregation(["g"], aggs, P.TableScan("T"))
    ref, _ = QueryRunner(plan, settings=Settings()).run({"T": blk})
    s = Settings(max_bytes_before_external_group_by=20_000,
                 spill_dir=str(tmp_path))
    got, summary = QueryRunner(plan, settings=s).run({"T": blk})
    assert "groupagg out-of-core" in summary.plan_text
    gref, ggot = _norm(ref), _norm(got)
    for k in gref:
        for a, b in zip(gref[k], ggot[k]):
            if isinstance(a, float):
                assert abs(a - b) < 1e-9 * max(1, abs(a)), k
            else:
                assert a == b, k


def test_groupagg_with_topn_wrapper(tmp_path):
    """TopN above the aggregation re-applies over the merged partials."""
    rng = np.random.default_rng(37)
    n = 12_000
    from tiflash_jax.ops.sort import SortKey

    sch = {"g": dt.INT64, "v": dt.INT64}
    t = {"g": [int(x) for x in rng.integers(0, 500, n)],
         "v": [int(x) for x in rng.integers(0, 1000, n)]}
    blk = O.pytable_to_block(t, sch)
    plan = P.TopN(
        [SortKey("cd", desc=True), SortKey("g")], 7,
        P.Aggregation(["g"], [AggDesc("count_distinct", "v", "cd")],
                      P.TableScan("T")))
    ref, _ = QueryRunner(plan, settings=Settings()).run({"T": blk})
    s = Settings(max_bytes_before_external_group_by=8_000,
                 spill_dir=str(tmp_path))
    got, summary = QueryRunner(plan, settings=s).run({"T": blk})
    assert "groupagg out-of-core" in summary.plan_text
    O.assert_tables_equal(_norm(got), _norm(ref), ordered=True)
