"""Randomized plan fuzzing: engine vs oracle over generated plan trees.

Role analog: the reference's randomized executor tests
(``Flash/tests/gtest_aggregation_executor.cpp`` /
``gtest_join_executor.cpp`` families randomize key types, block sizes and
concurrency).  Here a seeded generator builds random plan trees —
Selection / Projection / Aggregation / Join / TopN / Limit over random
schemas with NULLs — and every tree must match the independent python
oracle exactly, single-chip AND on the 8-device mesh (auto-distributed).
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle

INT_COLS = ["a", "b"]
STR_COL = "s"
VAL_COL = "v"
FLT_COL = "f"

SCHEMA = {
    "a": dt.INT64,
    "b": dt.INT32.with_nullable(True),
    "s": dt.STRING.with_nullable(True),
    "v": dt.INT64,
    "f": dt.FLOAT64.with_nullable(True),
    "d": dt.Decimal(10, 2, nullable=True),
}
R_SCHEMA = {
    "k": dt.INT64,
    "w": dt.INT64.with_nullable(True),
}


def _rand_pred(rng):
    c = rng.choice(["lt", "ge", "eq_str", "null", "and"])
    if c == "lt":
        return call("less", col("a"), lit(int(rng.integers(-40, 40))))
    if c == "ge":
        return call("greater_or_equals", col("v"),
                    lit(int(rng.integers(-40, 40))))
    if c == "eq_str":
        return call("not_equals", col("s"), lit("aa"))
    if c == "null":
        return call("is_not_null", col("b"))
    return call("and", _rand_pred(rng), _rand_pred(rng))


def _rand_proj(rng):
    from tiflash_jax.expr.nodes import cast

    exprs = {n: col(n) for n in SCHEMA}
    pick = rng.choice(["arith", "cond", "strfn", "cast_fi", "cast_if"])
    if pick == "arith":
        exprs["x"] = call("plus", call("multiply", col("a"), lit(3)),
                          col("v"))
    elif pick == "cond":
        exprs["x"] = call("if", call("less", col("a"), lit(0)),
                          col("v"), call("negate", col("v")))
    elif pick == "cast_fi":
        exprs["x"] = cast(col("f"), dt.INT64.with_nullable(True))
    elif pick == "cast_if":
        exprs["x"] = cast(col("a"), dt.FLOAT64)
    else:
        exprs["x"] = call("length", col("s"))
    return exprs


def _rand_aggs(rng, has_x):
    pool = [AggDesc("sum", VAL_COL, "sv"),
            AggDesc("count", None, "c"),
            AggDesc("min", "b", "mb"),
            AggDesc("max", VAL_COL, "mx"),
            AggDesc("avg", "f", "af"),
            AggDesc("count_distinct", "b", "cd"),
            AggDesc("bit_or", VAL_COL, "bo"),
            AggDesc("sum", "d", "sd"),
            AggDesc("min", "d", "md"),
            AggDesc("avg", "d", "ad")]
    if has_x:
        pool.append(AggDesc("sum", "x", "sx"))
    n = int(rng.integers(2, 5))
    idx = rng.choice(len(pool), size=n, replace=False)
    return [pool[i] for i in idx]


def _build_plan(rng):
    node = P.TableScan("t")
    has_x = False
    if rng.random() < 0.7:
        node = P.Selection(_rand_pred(rng), node)
    if rng.random() < 0.5:
        node = P.Projection(_rand_proj(rng), node)
        has_x = True
    joined = False
    if rng.random() < 0.5:
        kind = str(rng.choice(["inner", "left_outer", "semi", "anti",
                               "right_outer", "full_outer"]))
        node = P.Join(kind=kind, probe_keys=["a"], build_keys=["k"],
                      probe=node, build=P.TableScan("r"),
                      output_capacity=4000)
        # semi/anti joins emit no build-side columns
        joined = kind in ("inner", "left_outer", "right_outer", "full_outer")
    shape = rng.choice(["agg", "topn", "limit", "plain"])
    if shape == "agg":
        keys = [str(rng.choice(["s", "b"] if not joined else ["s", "b", "w"]))]
        node = P.Aggregation(keys=keys, aggs=_rand_aggs(rng, has_x),
                             child=node)
    elif shape == "topn":
        # random direction + NULL placement: None (MySQL default),
        # explicit first, explicit last
        nf = [None, True, False][int(rng.integers(0, 3))]
        keys = [SortKey(VAL_COL, desc=bool(rng.integers(0, 2)),
                        nulls_first=nf),
                SortKey("a", desc=bool(rng.integers(0, 2)))]
        node = P.TopN(keys, int(rng.integers(1, 40)), node)
    elif shape == "limit":
        node = P.Limit(int(rng.integers(1, 60)), node)
    return node, shape


def _tables(rng):
    n = int(rng.integers(60, 220))
    t = O.random_pytable(rng, n, SCHEMA, int_range=(-50, 50),
                         str_pool=("aa", "bb", "cc", "", "dd"))
    r = O.random_pytable(rng, int(rng.integers(10, 60)), R_SCHEMA,
                         int_range=(-50, 50))
    return {"t": t, "r": r}


def _norm(table, float_cols=("af", "f", "x", "sx", "ad")):
    cols = sorted(table.keys())
    rows = []
    for i in range(len(table[cols[0]]) if cols else 0):
        row = []
        for c in cols:
            v = table[c][i]
            if c in float_cols and v is not None:
                v = round(float(v), 6)
            if hasattr(v, "as_tuple"):  # Decimal avg results
                v = round(float(v), 6)
            row.append((v is None, v if v is not None else 0))
        rows.append(tuple(row))
    return sorted(rows)


@pytest.mark.parametrize("seed", range(60))
def test_fuzz_plan_matches_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    tables = _tables(rng)
    plan, shape = _build_plan(rng)
    blocks = {n: O.pytable_to_block(t, SCHEMA if n == "t" else R_SCHEMA)
              for n, t in tables.items()}
    out, ov = compile_fragment(plan)(blocks)
    for k, v in ov.items():
        assert int(np.asarray(v)) == 0, (k, plan.pretty())
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, tables)
    if shape in ("limit",):  # LIMIT keeps an arbitrary subset: sizes only
        assert len(next(iter(got.values()), [])) == \
            len(next(iter(want.values()), [])), plan.pretty()
        return
    assert _norm(got) == _norm(want), plan.pretty()


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_fuzz_plan_distributed_matches(seed):
    """The same random tree, auto-distributed over the 8-device mesh."""
    import jax
    from jax.sharding import Mesh

    from tiflash_jax.runtime.executor import run_query

    rng = np.random.default_rng(1000 + seed)
    tables = _tables(rng)
    plan, shape = _build_plan(rng)
    if shape == "limit":
        pytest.skip("LIMIT row-set is order-dependent")
    blocks = {n: O.pytable_to_block(t, SCHEMA if n == "t" else R_SCHEMA)
              for n, t in tables.items()}
    out1, _ = run_query(plan, blocks)
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    out2, _ = run_query(plan, blocks, mesh=mesh)
    assert _norm(O.block_to_pytable(out1)) == _norm(O.block_to_pytable(out2))


def test_null_group_not_split_after_join():
    """Regression (found by this fuzzer): left-outer join non-matches
    carry arbitrary payload data under validity=False; aggregation must
    canonicalize NULL key slots or the NULL group splits."""
    t = {"a": [1, 2, 3, 4], "v": [10, 20, 30, 40]}
    r = {"k": [1], "w": [7]}
    blocks = {"t": O.pytable_to_block(t, {"a": dt.INT64, "v": dt.INT64}),
              "r": O.pytable_to_block(r, {"k": dt.INT64,
                                          "w": dt.INT64.with_nullable(True)})}
    plan = P.Aggregation(
        keys=["w"], aggs=[AggDesc("count", None, "c"),
                          AggDesc("sum", "v", "sv")],
        child=P.Join(kind="left_outer", probe_keys=["a"], build_keys=["k"],
                     probe=P.TableScan("t"), build=P.TableScan("r"),
                     output_capacity=16))
    out, ov = compile_fragment(plan)(blocks)
    got = O.block_to_pytable(out)
    rows = sorted(zip(got["w"], got["c"], got["sv"]),
                  key=lambda x: (x[0] is None, x[0]))
    assert rows == [(7, 1, 10), (None, 3, 90)], rows


# --- window / grouping-sets fuzz shapes --------------------------------------

def _rand_window(rng, node):
    from tiflash_jax.ops.window import WindowDesc

    pool = [WindowDesc("row_number", "rn"),
            WindowDesc("rank", "rk"),
            WindowDesc("dense_rank", "dr"),
            WindowDesc("sum", "ws", arg=VAL_COL),
            WindowDesc("min", "wm", arg=VAL_COL,
                       frame=(int(rng.integers(0, 4)), int(rng.integers(0, 4)))),
            WindowDesc("lag", "lg", arg=VAL_COL, offset=1),
            WindowDesc("lead", "ld", arg=VAL_COL, offset=2, default=0)]
    n = int(rng.integers(2, 5))
    idx = rng.choice(len(pool), size=n, replace=False)
    part = [str(rng.choice(["s", "b"]))]
    # first order key randomly nullable ("b") to exercise NULL ordering
    # (and NULL peer groups for rank) inside window partitions
    if rng.random() < 0.35:
        # RANGE frames (single order key required): value-distance frame
        # bounds + NULL-peer-set semantics vs the oracle
        order1 = [SortKey(str(rng.choice([VAL_COL, "b"])),
                          desc=bool(rng.integers(0, 2)))]
        funcs = [WindowDesc("sum", "rs", arg=VAL_COL,
                            frame=(int(rng.integers(0, 6)),
                                   int(rng.integers(0, 6))),
                            frame_type="range"),
                 WindowDesc("rank", "rk")]
        return P.Window(part, order1, funcs, node)
    order = [SortKey(str(rng.choice([VAL_COL, "b"])),
                     desc=bool(rng.integers(0, 2))),
             SortKey("a", desc=False)]
    return P.Window(part, order, [pool[i] for i in idx], node)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_window_matches_oracle(seed):
    rng = np.random.default_rng(5000 + seed)
    tables = _tables(rng)
    node = P.TableScan("t")
    if rng.random() < 0.5:
        node = P.Selection(_rand_pred(rng), node)
    plan = _rand_window(rng, node)
    blocks = {n: O.pytable_to_block(t, SCHEMA if n == "t" else R_SCHEMA)
              for n, t in tables.items()}
    out, ov = compile_fragment(plan)(blocks)
    for k, v in ov.items():
        assert int(np.asarray(v)) == 0, (k, plan.pretty())
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, tables)
    assert _norm(got) == _norm(want), plan.pretty()


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_grouping_sets_matches_oracle(seed):
    rng = np.random.default_rng(7000 + seed)
    tables = _tables(rng)
    node = P.TableScan("t")
    if rng.random() < 0.6:
        node = P.Selection(_rand_pred(rng), node)
    sets = [["s", "b"], ["s"], []]
    if rng.random() < 0.5:
        sets = [["b"], []]
    node = P.Expand(sets, node)
    keys = sorted({k for s in sets for k in s}) + ["groupingID"]
    plan = P.Aggregation(keys=keys, aggs=[
        AggDesc("sum", VAL_COL, "sv"), AggDesc("count", None, "c")],
        child=node)
    blocks = {n: O.pytable_to_block(t, SCHEMA if n == "t" else R_SCHEMA)
              for n, t in tables.items()}
    out, ov = compile_fragment(plan)(blocks)
    for k, v in ov.items():
        assert int(np.asarray(v)) == 0, (k, plan.pretty())
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, tables)
    assert _norm(got) == _norm(want), plan.pretty()
