"""Resource-limit settings (Settings.h max_rows_to_read /
max_rows_to_group_by / max_rows_in_join / max_rows_to_sort /
max_result_rows + OverflowMode, max_subquery_depth): pre-flight checks
for host-known facts, throw-after checks against the EXPLAIN ANALYZE
row counters for operator limits."""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import col
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.errors import LIMIT_EXCEEDED, EngineError
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.testing import oracle as O


@pytest.fixture(scope="module")
def blk():
    rng = np.random.default_rng(5)
    n = 1000
    return O.pytable_to_block(
        {"g": [int(x) for x in rng.integers(0, 50, n)],
         "v": [int(x) for x in rng.integers(0, 100, n)]},
        {"g": dt.INT64, "v": dt.INT64})


AGG = lambda: P.Aggregation(["g"], [AggDesc("sum", "v", "s")],
                            P.TableScan("T"))


def _expect_limit(plan, blk, settings):
    with pytest.raises(EngineError) as ei:
        run_query(plan, {"T": blk}, settings=settings)
    assert ei.value.code == LIMIT_EXCEEDED


def test_max_rows_to_read(blk):
    _expect_limit(AGG(), blk, Settings(max_rows_to_read=999))
    out, _ = run_query(AGG(), {"T": blk},
                       settings=Settings(max_rows_to_read=1000))
    assert out.to_pylists()["g"]


def test_max_rows_to_group_by(blk):
    _expect_limit(AGG(), blk, Settings(max_rows_to_group_by=49))
    out, _ = run_query(AGG(), {"T": blk},
                       settings=Settings(max_rows_to_group_by=50))
    assert len(out.to_pylists()["g"]) == 50


def test_max_rows_in_join(blk):
    plan = P.Join(kind="inner", probe_keys=["g"], build_keys=["g"],
                  probe=P.TableScan("T"), build=P.Selection(
                      col("v") < 0, P.TableScan("T")),
                  output_capacity=1 << 12)
    # no build rows survive -> join emits 0 live rows; limit 10 passes
    out, _ = run_query(plan, {"T": blk},
                       settings=Settings(max_rows_in_join=10))
    assert int(np.asarray(out.num_rows())) == 0
    plan2 = P.Join(kind="inner", probe_keys=["g"], build_keys=["g"],
                   probe=P.TableScan("T"), build=P.TableScan("T"),
                   output_capacity=1 << 16)
    _expect_limit(plan2, blk, Settings(max_rows_in_join=10))


def test_max_rows_to_sort_and_result(blk):
    plan = P.Sort([SortKey("v")], P.TableScan("T"))
    _expect_limit(plan, blk, Settings(max_rows_to_sort=999))
    _expect_limit(plan, blk, Settings(max_result_rows=999))
    # break mode truncates instead
    out, summary = run_query(
        plan, {"T": blk},
        settings=Settings(max_result_rows=7, result_overflow_mode="break"))
    assert summary.result_rows == 7
    got = out.to_pylists()["v"]
    assert len(got) == 7 and got == sorted(got)


def test_max_subquery_depth(blk):
    plan = AGG()
    _expect_limit(plan, blk, Settings(max_subquery_depth=1))
    out, _ = run_query(plan, {"T": blk},
                       settings=Settings(max_subquery_depth=16))
    assert out is not None


def test_max_ast_depth(blk):
    """Settings.h max_ast_depth: pre-flight expression-depth guard."""
    deep = col("v")
    for _ in range(20):
        deep = deep + 1
    plan = P.Projection({"x": deep}, P.TableScan("T"))
    _expect_limit(plan, blk, Settings(max_ast_depth=5))
    out, _ = run_query(plan, {"T": blk},
                       settings=Settings(max_ast_depth=64))
    assert out is not None


def test_max_spilled_rows_per_file(blk, tmp_path):
    """Settings.h max_spilled_rows_per_file caps out-of-core chunk rows
    on top of the byte budget (result parity with in-memory)."""
    plan = AGG()
    want, _ = run_query(plan, {"T": blk})
    got, summary = run_query(
        plan, {"T": blk},
        settings=Settings(max_bytes_before_external_group_by=1,
                          max_spilled_rows_per_file=100,
                          spill_dir=str(tmp_path)))
    assert "out-of-core" in summary.plan_text
    assert O.sort_pytable(O.block_to_pytable(got)) == \
        O.sort_pytable(O.block_to_pytable(want))
