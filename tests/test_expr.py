"""Expression-layer parity tests vs the row-at-a-time oracle.

Role analog: ``dbms/src/Functions/tests`` (FunctionTest fixtures) and
``tests/fullstack-test/expr/`` — randomized columns, engine vs oracle.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block, column_from_numpy as cfn
from tiflash_jax.expr.nodes import call, case_when, col, if_, lit
from tiflash_jax.expr.compile import evaluate_expr
from tiflash_jax.testing import oracle as O


SCHEMA = {
    "a": dt.INT64,
    "b": dt.INT32.with_nullable(True),
    "c": dt.Decimal(12, 2),
    "d": dt.Decimal(10, 2, nullable=True),
    "f": dt.FLOAT64.with_nullable(True),
    "s": dt.STRING.with_nullable(True),
    "t": dt.DATE,
    "bo": dt.BOOL.with_nullable(True),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    table = O.random_pytable(rng, 300, SCHEMA)
    block = O.pytable_to_block(table, SCHEMA)
    return table, block


def check(expr, data, result_dtype_hint=None, approx=False):
    table, block = data
    got_col = evaluate_expr(expr, block)
    got = O.block_to_pytable(Block(names=("r",), columns=(got_col,)))["r"]
    want = O.eval_expr_table(expr, table)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if approx and g is not None and w is not None:
            assert abs(float(g) - float(w)) < 1e-9, (i, g, w)
        else:
            assert O._py_eq(
                g if not isinstance(w, bool) else (None if g is None else bool(g)), w
            ), (i, g, w, expr)


ARITH_CASES = [
    col("a") + col("b"),
    col("a") - lit(7),
    col("a") * col("b"),
    col("c") + col("d"),
    col("c") - col("d"),
    col("c") * col("d"),
    call("negate", col("c")),
    call("abs", col("b")),
    col("a") % col("b"),
    call("int_div", col("a"), col("b")),
]


@pytest.mark.parametrize("expr", ARITH_CASES, ids=[str(e) for e in ARITH_CASES])
def test_arithmetic(expr, data):
    check(expr, data)


def test_decimal_divide(data):
    check(col("c") / col("d"), data)


def test_float_arith(data):
    check(col("f") * col("f") + col("f"), data, approx=True)
    check(col("f") / col("f"), data, approx=True)


CMP_CASES = [
    col("a") > col("b"),
    col("a") <= lit(5),
    col("c") >= col("d"),
    col("c") < 0.5,
    col("c") == 0.25,
    col("t") >= "1995-01-01",
    col("t") < "1994-06-07",
    col("s") == "bb",
    col("s") != "bb",
    col("s") < "bb",
    col("s") >= "b",
    col("s") <= "zz",
    col("s") > "",
]


@pytest.mark.parametrize("expr", CMP_CASES, ids=[str(i) for i in range(len(CMP_CASES))])
def test_comparisons(expr, data):
    check(expr, data)


LOGIC_CASES = [
    (col("a") > 0) & (col("b") > 0),
    (col("bo")) | (col("b") > 50),
    ~col("bo"),
    (col("bo") & (col("a") > 0)) | col("d").is_null(),
    call("is_not_null", col("d")),
]


@pytest.mark.parametrize("expr", LOGIC_CASES, ids=[str(i) for i in range(len(LOGIC_CASES))])
def test_logic_three_valued(expr, data):
    check(expr, data)


def test_conditionals(data):
    check(if_(col("a") > 0, col("a"), col("b")), data)
    check(call("coalesce", col("b"), col("a")), data)
    check(
        case_when((col("a") > 50, lit(1)), (col("a") > 0, lit(2)), default=lit(3)),
        data,
    )
    check(case_when((col("bo"), col("a")),), data)


def test_in_and_like(data):
    check(col("s").in_("aa", "cc"), data)
    check(col("a").in_(1, 2, 3), data)
    check(call("like", col("s"), lit("b%")), data)
    check(call("like", col("s"), lit("%b")), data)


def test_date_parts(data):
    check(call("year", col("t")), data)
    check(call("month", col("t")), data)
    check(call("day_of_month", col("t")), data)


def test_string_column_vs_column_cross_dictionary():
    """Comparing string columns from different tables (different
    dictionaries) must compare the STRINGS, not the raw codes."""
    a = cfn(["apple", "pear", "zebra", "kiwi"], dt.STRING)
    b_vals = ["pear", "apple", "aaa", "kiwi"]
    b = cfn(b_vals, dt.STRING)
    block = Block.from_dict({"a": a, "b": b})
    for op, pyop in [("equals", lambda x, y: x == y),
                     ("less", lambda x, y: x < y),
                     ("greater_or_equals", lambda x, y: x >= y)]:
        from tiflash_jax.expr.nodes import call as _call

        got = evaluate_expr(_call(op, col("a"), col("b")), block).to_pylist()
        want = [pyop(x, y) for x, y in zip(["apple", "pear", "zebra", "kiwi"], b_vals)]
        assert got == want, (op, got, want)


def test_mod_div_64bit_boundaries():
    """MOD truncates toward zero and DIV truncates (not floors) at the
    64-bit boundaries, and BIGINT UNSIGNED keeps its full 2^64 magnitude.
    Checked against HARD-CODED MySQL answers — the oracle once shared the
    engine's floor-division bug, so oracle parity alone cannot gate this.
    Reference semantics: dbms/src/Functions/{modulo,divide}.cpp and
    tests/fullstack-test/expr/mod_extra.test."""
    IMIN, IMAX, UMAX = -2**63, 2**63 - 1, 2**64 - 1

    def run(op, xs, ys, tx, ty):
        block = Block.from_dict({"x": cfn(xs, tx), "y": cfn(ys, ty)})
        out = evaluate_expr(call(op, col("x"), col("y")), block)
        return out.to_pylist()

    # --- signed x signed ---------------------------------------------
    xs = [IMIN, IMIN, -5, 5, IMAX, IMIN, 7]
    ys = [5, -3, 3, -3, -3, 0, 0]
    assert run("modulo", xs, ys, dt.INT64, dt.INT64) == \
        [-3, -2, -2, 2, 1, None, None]
    assert run("int_div", xs, ys, dt.INT64, dt.INT64) == \
        [-1844674407370955161, 3074457345618258602, -1, -1,
         -3074457345618258602, None, None]

    # --- signed x unsigned (magnitude above 2^63 must survive) -------
    xs = [5, -5, IMIN, IMAX, 5]
    ys = [UMAX, UMAX, UMAX, UMAX, 0]
    assert run("modulo", xs, ys, dt.INT64, dt.UINT64) == \
        [5, -5, IMIN, IMAX, None]
    assert run("int_div", xs, ys, dt.INT64, dt.UINT64) == [0, 0, 0, 0, None]

    # --- unsigned x signed / unsigned x unsigned ----------------------
    xs = [UMAX, UMAX, UMAX, UMAX]
    ys = [IMAX, 5, -3, IMIN]
    assert run("modulo", xs, ys, dt.UINT64, dt.INT64) == [1, 0, 0, IMAX]
    assert run("int_div", xs, ys, dt.UINT64, dt.INT64) == \
        [2, 3689348814741910323, -6148914691236517205, -1]
    assert run("modulo", [UMAX, UMAX], [UMAX, 3],
               dt.UINT64, dt.UINT64) == [0, 0]
    assert run("int_div", [UMAX, UMAX], [UMAX, 3],
               dt.UINT64, dt.UINT64) == [1, 6148914691236517205]

    # the oracle must agree from its OWN arithmetic (independence check)
    for a, b, want_mod, want_div in [
        (IMIN, 5, -3, -1844674407370955161),
        (-5, 3, -2, -1),
        (5, -3, 2, -1),
        (5, UMAX, 5, 0),
        (UMAX, IMAX, 1, 2),
    ]:
        from tiflash_jax.expr.nodes import call as _c
        assert O.eval_expr_row(_c("modulo", col("x"), col("y")),
                               {"x": a, "y": b}) == want_mod
        assert O.eval_expr_row(_c("int_div", col("x"), col("y")),
                               {"x": a, "y": b}) == want_div


def test_float_fmod_exactness():
    """Float MOD is C fmod — exact even when a/b overflows the 53-bit
    quotient (5 % 3e-308).  Denormal RESULTS flush to 0 (XLA is FTZ for
    f64; documented deviation)."""
    import math

    xs = [5.0, -5.0, 1.3, 9.223372036854776e18, 5.0, 0.0]
    ys = [3e-308, 3e-308, 1.1, 1.1, 1.234567890123e69, 1.1]
    block = Block.from_dict({"x": cfn(xs, dt.FLOAT64),
                             "y": cfn(ys, dt.FLOAT64)})
    got = evaluate_expr(call("modulo", col("x"), col("y")), block).to_pylist()
    for g, x, y in zip(got, xs, ys):
        w = math.fmod(x, y)
        if abs(w) < 2.2250738585072014e-308 and w != 0.0:
            assert g == 0.0 or g == w  # denormal may flush
        else:
            assert g == w, (x, y, g, w)
