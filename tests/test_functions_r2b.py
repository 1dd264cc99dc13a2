"""Round-2 second breadth burst: NULL-safe equals, ILIKE + LIKE escape,
SPACE/CHAR, INET_NTOA/INET6_* — all vs the oracle.

Reference surface: tidbNullEQ / ilike3Args / like3Args / space /
IPv4NumToString / tiDBIPv6StringToNum / tiDBIPv6NumToString sigs mapped
at /root/reference/dbms/src/Flash/Coprocessor/DAGUtils.cpp:92.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block
from tiflash_jax.core.dtypes import TypeKind
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.expr.compile import evaluate_expr
from tiflash_jax.testing import oracle as O

SCHEMA = {
    "i": dt.INT64.with_nullable(True),
    "j": dt.INT64.with_nullable(True),
    "p": dt.INT32,
    "f": dt.FLOAT64.with_nullable(True),
    "s": dt.STRING.with_nullable(True),
    "s2": dt.STRING.with_nullable(True),
    "ip": dt.STRING,
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    table = O.random_pytable(
        rng, 250, SCHEMA, int_range=(-60, 60),
        str_pool=("Alpha", "beta", "al%pha", "A_B", "", "Éé", "x\\y"),
    )
    ips = ["1.2.3.4", "255.255.255.255", "10.0.0", "::1", "0.0.0.0",
           "2001:db8::ff00:42:8329", "nope", "01.2.3.4", "1.2",
           "fe80::", "::ffff:192.0.2.1"]
    n = len(table["i"])
    table["ip"] = [ips[int(rng.integers(0, len(ips)))] for _ in range(n)]
    return table, O.pytable_to_block(table, SCHEMA)


def check(expr, data, approx=False):
    table, block = data
    got_col = evaluate_expr(expr, block)
    got = O.block_to_pytable(Block(names=("r",), columns=(got_col,)))["r"]
    want = O.eval_expr_table(expr, table)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (i, g, w, expr)
        elif approx:
            assert abs(float(g) - float(w)) < 1e-9 * max(1, abs(float(w))), (i, g, w, expr)
        else:
            assert O._py_eq(g if not isinstance(w, bool) else bool(g), w), (i, g, w, expr)


NULL_EQ_CASES = [
    call("null_eq", col("i"), col("j")),
    call("null_eq", col("i"), lit(7)),
    call("null_eq", col("f"), col("f")),
    call("null_eq", col("s"), col("s2")),
    call("null_eq", col("s"), lit("beta")),
]


@pytest.mark.parametrize("expr", NULL_EQ_CASES,
                         ids=[str(i) for i in range(len(NULL_EQ_CASES))])
def test_null_eq(expr, data):
    check(expr, data)


def test_null_eq_never_null(data):
    _, block = data
    c = evaluate_expr(call("null_eq", col("i"), col("j")), block)
    assert c.validity is None and not c.dtype.nullable


LIKE_CASES = [
    call("ilike", col("s"), lit("al%")),
    call("ilike", col("s"), lit("%A")),
    call("ilike", col("s"), lit("a_pha")),
    call("like", col("s"), lit("al|%pha"), lit("|")),
    call("like", col("s"), lit("A|_B"), lit("|")),
    call("ilike", col("s"), lit("a|_b"), lit("|")),
]


@pytest.mark.parametrize("expr", LIKE_CASES,
                         ids=[str(i) for i in range(len(LIKE_CASES))])
def test_ilike_and_escape(expr, data):
    check(expr, data)


def test_space_char(data):
    check(call("concat", call("space", col("p")), lit("!")), data)
    check(call("char", col("p")), data)
    check(call("char", col("p"), lit(77), lit(121)), data)


def test_inet_ntoa_roundtrip(data):
    # inet_aton gives u32-scale ints; inet_ntoa needs a proven range, so
    # drive it from a small int column mapped through plus
    check(call("inet_ntoa", col("p")), data)
    check(call("inet_ntoa", call("plus", col("p"), lit(16909060))), data)


def test_inet6(data):
    check(call("inet6_aton", col("ip")), data)
    check(call("inet6_ntoa", call("inet6_aton", col("ip"))), data)


# --- datetime unit breadth ---------------------------------------------------

DT_SCHEMA = {
    "t": dt.DATE,
    "tn": dt.DATE.with_nullable(True),
    "ts": dt.DataType(TypeKind.DATETIME),
    "p": dt.INT32,
}


@pytest.fixture(scope="module")
def dtdata():
    rng = np.random.default_rng(57)
    table = O.random_pytable(rng, 220, DT_SCHEMA, int_range=(-40, 40))
    return table, O.pytable_to_block(table, DT_SCHEMA)


DT_CASES = [
    call("date_add_weeks", col("t"), col("p")),
    call("date_sub_weeks", col("ts"), lit(3)),
    call("date_add_quarters", col("tn"), lit(5)),
    call("date_sub_quarters", col("t"), col("p")),
    call("date_add_hours", col("ts"), col("p")),
    call("date_add_minutes", col("t"), lit(61)),
    call("date_sub_seconds", col("ts"), lit(3601)),
    call("date_add_microseconds", col("ts"), lit(999_999)),
    call("date_add_days", col("ts"), lit(2)),   # DATETIME preserved now
    call("date_add", col("t"), col("p"), lit("WEEK")),
    call("date_add", col("ts"), lit(2), lit("QUARTER")),
    call("date_sub", col("ts"), lit(90), lit("MINUTE")),
    call("date_sub", col("t"), lit(1), lit("YEAR")),
]


@pytest.mark.parametrize("expr", DT_CASES,
                         ids=[str(i) for i in range(len(DT_CASES))])
def test_date_units(expr, dtdata):
    check(expr, dtdata)


EXTRACT_UNITS = ["YEAR", "QUARTER", "MONTH", "WEEK", "DAY", "HOUR", "MINUTE",
                 "SECOND", "MICROSECOND", "YEAR_MONTH", "DAY_HOUR",
                 "DAY_MINUTE", "DAY_SECOND", "HOUR_MINUTE", "HOUR_SECOND",
                 "MINUTE_SECOND", "SECOND_MICROSECOND", "MINUTE_MICROSECOND",
                 "HOUR_MICROSECOND", "DAY_MICROSECOND"]


@pytest.mark.parametrize("unit", EXTRACT_UNITS)
def test_extract(unit, dtdata):
    check(call("extract", lit(unit), col("ts")), dtdata)
    if unit in ("YEAR", "MONTH", "WEEK", "DAY", "YEAR_MONTH", "QUARTER"):
        check(call("extract", lit(unit), col("tn")), dtdata)


# --- query clock family (engine-only: deterministic under query_clock) -------

def test_now_family(dtdata):
    import datetime as pydt
    from tiflash_jax.expr.compile import query_clock
    _, block = dtdata
    us = 1_700_000_123_456_789
    with query_clock(us):
        for fn in ("now", "current_timestamp", "sysdate", "utc_timestamp"):
            c = evaluate_expr(call(fn), block)
            vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
            assert vals[0] == pydt.datetime(1970, 1, 1) + pydt.timedelta(
                microseconds=us)
            assert len(set(vals)) == 1
        c = evaluate_expr(call("curdate"), block)
        vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
        assert vals[0] == (pydt.datetime(1970, 1, 1)
                           + pydt.timedelta(microseconds=us)).date()
        c = evaluate_expr(call("curtime"), block)
        vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
        exp = (pydt.datetime(1970, 1, 1) + pydt.timedelta(microseconds=us))
        assert vals[0] == exp.strftime("%H:%M:%S")
        c = evaluate_expr(call("unix_timestamp"), block)
        vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
        assert vals[0] == us // 1_000_000
        # composable: NOW() comparisons against date columns
        c = evaluate_expr(call("less", col("t"), call("curdate")), block)
        assert c.dtype.kind is TypeKind.BOOL


def test_get_format(dtdata):
    _, block = dtdata
    c = evaluate_expr(call("get_format", lit("DATE"), lit("USA")), block)
    vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
    assert vals[0] == "%m.%d.%Y"
    # usable as a date_format pattern
    c = evaluate_expr(call("date_format", col("t"), lit("%m.%d.%Y")), block)
    assert c.dtype.is_string


def test_rand(dtdata):
    _, block = dtdata
    c1 = evaluate_expr(call("rand", lit(7)), block)
    c2 = evaluate_expr(call("rand", lit(7)), block)
    c3 = evaluate_expr(call("rand", lit(8)), block)
    v1 = np.asarray(c1.data)
    assert ((v1 >= 0) & (v1 < 1)).all()
    assert np.array_equal(v1, np.asarray(c2.data))
    assert not np.array_equal(v1, np.asarray(c3.data))
    assert len(np.unique(v1)) > len(v1) // 2
    from tiflash_jax.expr.compile import query_clock
    with query_clock(123_456_789):
        c4 = evaluate_expr(call("rand"), block)
        assert ((np.asarray(c4.data) >= 0) & (np.asarray(c4.data) < 1)).all()


def test_adddate_interval_form(dtdata):
    check(call("adddate", col("t"), lit(2), lit("MONTH")), dtdata)
    check(call("subdate", col("ts"), lit(36), lit("HOUR")), dtdata)
    check(call("adddate", col("t"), lit(9)), dtdata)  # 2-arg still days


# --- grouping() family over Expand gids --------------------------------------

def test_grouping_functions():
    """GROUPING over an Expand gid column, checked against the plan oracle
    (reference Functions/FunctionsGrouping.h three modes)."""
    import tiflash_jax.plan.nodes as P
    from tiflash_jax.plan.compiler import compile_fragment
    from tiflash_jax.testing.plan_oracle import execute_plan_oracle

    rng = np.random.default_rng(3)
    schema = {"a": dt.STRING, "b": dt.INT32, "v": dt.INT64}
    t = O.random_pytable(rng, 80, schema, null_prob=0)
    blocks = {"t": O.pytable_to_block(t, schema)}
    # ROLLUP(a, b): sets {(a,b)=1, (a)=2, ()=3}; b aggregated for gid>=2,
    # a aggregated for gid==3
    plan = P.Projection(
        {"a": col("a"), "b": col("b"), "v": col("v"),
         "ga": call("grouping", col("groupingID"), lit(1), lit(2)),
         "gb": call("grouping", col("groupingID"), lit(1)),
         "cmp": call("grouping_cmp", col("groupingID"), lit(1), lit(2)),
         "bits": call("grouping_bit_and", col("groupingID"), lit(1), lit(2))},
        P.Expand([["a", "b"], ["a"], []], P.TableScan("t")),
    )
    out, ov = compile_fragment(plan)(blocks)
    assert all(int(np.asarray(v)) == 0 for v in ov.values())
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, {"t": t})
    O.assert_tables_equal(got, want)
    # spot semantics: gid 1 (full set) -> nothing aggregated
    for ga, gb in zip(got["ga"], got["gb"]):
        assert ga in (0, 1) and gb in (0, 1)


# --- JSON construction -------------------------------------------------------

def test_json_build(data):
    check(call("json_array", lit(1), col("s"), lit(None), lit(2.5)), data)
    check(call("json_array", col("s")), data)
    check(call("json_object", lit("k"), col("s"), lit("n"), lit(7)), data)
    check(call("json_object", lit("a"), lit(1)), data)
    # composable with json functions
    check(call("json_length", call("json_array", lit(1), col("s"))), data)


# --- CAST(string AS ...) dictionary-LUT parse --------------------------------

def test_cast_string_to_numbers_and_dates():
    """MySQL coercion: numeric prefix parses, junk is 0, bad dates NULL —
    and dictionary CODES never leak as values (regression: the old
    numeric-cast path would astype the int32 codes)."""
    import datetime as pydt

    from tiflash_jax.core.block import column_from_numpy
    from tiflash_jax.expr.nodes import cast

    vals = ["12", "3.6", "-4.5", " 7.25e2 ", "12abc", "junk", "", "0.4"]
    block = Block.from_dict({"s": column_from_numpy(vals, dt.STRING)})
    out = O.block_to_pytable(Block(names=("r",), columns=(
        evaluate_expr(cast(col("s"), dt.INT64), block),)))["r"]
    assert out == [12, 4, -5, 725, 12, 0, 0, 0]
    out = O.block_to_pytable(Block(names=("r",), columns=(
        evaluate_expr(cast(col("s"), dt.FLOAT64), block),)))["r"]
    assert out == [12.0, 3.6, -4.5, 725.0, 12.0, 0.0, 0.0, 0.4]
    out = O.block_to_pytable(Block(names=("r",), columns=(
        evaluate_expr(cast(col("s"), dt.Decimal(10, 2)), block),)))["r"]
    assert [float(x) for x in out] == [12.0, 3.6, -4.5, 725.0, 12.0, 0.0, 0.0, 0.4]

    ds = ["2020-01-02", "2020/01/03", "20200104", "2020-01-05 06:07:08",
          "nope", "2020-13-40"]
    block = Block.from_dict({"s": column_from_numpy(ds, dt.STRING)})
    out = O.block_to_pytable(Block(names=("r",), columns=(
        evaluate_expr(cast(col("s"), dt.DATE), block),)))["r"]
    assert out[:4] == [pydt.date(2020, 1, 2), pydt.date(2020, 1, 3),
                       pydt.date(2020, 1, 4), pydt.date(2020, 1, 5)]
    assert out[4] is None and out[5] is None
    out = O.block_to_pytable(Block(names=("r",), columns=(
        evaluate_expr(cast(col("s"), dt.DataType(TypeKind.DATETIME)), block),)))["r"]
    assert out[3] == pydt.datetime(2020, 1, 5, 6, 7, 8)


def test_cast_date_datetime_roundtrip():
    import datetime as pydt

    from tiflash_jax.core.block import column_from_numpy
    from tiflash_jax.expr.nodes import cast

    days = [(pydt.date(2021, 3, 1) - pydt.date(1970, 1, 1)).days]
    block = Block.from_dict({
        "d": column_from_numpy(days, dt.DATE),
    })
    c = evaluate_expr(cast(col("d"), dt.DataType(TypeKind.DATETIME)), block)
    assert O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"][0] == \
        pydt.datetime(2021, 3, 1)
    back = evaluate_expr(cast(cast(col("d"), dt.DataType(TypeKind.DATETIME)),
                              dt.DATE), block)
    assert O.block_to_pytable(Block(names=("r",), columns=(back,)))["r"][0] == \
        pydt.date(2021, 3, 1)


# --- ROUND/TRUNCATE with fraction digits -------------------------------------

def test_round_frac_float_decimal_int():
    """tidbRoundWithFrac / tidbTruncateWithFrac (regression: the frac arg
    used to be silently ignored)."""
    from tiflash_jax.core.block import column_from_numpy

    table = {"f": [1.2345, -2.718, 9.995], "i": [125, -125, 4],
             "d": [None]}
    import decimal as pydec
    dvals = [pydec.Decimal("123.456"), pydec.Decimal("-9.995"),
             pydec.Decimal("0.004")]
    tab = {"f": table["f"], "i": table["i"], "d": dvals}
    schema = {"f": dt.FLOAT64, "i": dt.INT64, "d": dt.Decimal(10, 3)}
    block = O.pytable_to_block(tab, schema)
    for expr in [
        call("round", col("f"), lit(2)),
        call("truncate", col("f"), lit(1)),
        call("ceil", col("f"), lit(1)),
        call("floor", col("f"), lit(2)),
        call("round", col("i"), lit(-1)),
        call("truncate", col("i"), lit(-2)),
        call("round", col("i"), lit(3)),
        call("round", col("d"), lit(1)),
        call("round", col("d"), lit(-1)),
        call("truncate", col("d"), lit(2)),
        call("round", col("d"), lit(7)),
    ]:
        got_col = evaluate_expr(expr, block)
        got = O.block_to_pytable(Block(names=("r",), columns=(got_col,)))["r"]
        want = O.eval_expr_table(expr, tab)
        for i, (g, w) in enumerate(zip(got, want)):
            assert abs(float(g) - float(w)) < 1e-9, (i, g, w, expr)
    # spot values
    c = evaluate_expr(call("round", col("f"), lit(2)), block)
    # 9.995 as a binary double is 9.99499…, so (like MySQL on DOUBLE) 9.99
    assert O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"] == \
        [1.23, -2.72, 9.99]
    c = evaluate_expr(call("round", col("i"), lit(-1)), block)
    assert O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"] == \
        [130, -130, 0]
    c = evaluate_expr(call("round", col("d"), lit(1)), block)
    assert [str(x) for x in
            O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]] == \
        ["123.5", "-10.0", "0.0"]


def test_info_functions(dtdata):
    _, block = dtdata
    for fn, want in [("version", "8.0.11-TiDB-tiflash-jax-0.2"),
                     ("database", "default"), ("user", "root@%")]:
        c = evaluate_expr(call(fn), block)
        vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
        assert vals[0] == want and len(set(vals)) == 1
    c = evaluate_expr(call("connection_id"), block)
    assert O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"][0] == 0
    # composable: LIKE over version()
    c = evaluate_expr(call("like", call("version"), lit("%TiDB%")), block)
    assert all(O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"])


def test_str_to_date_datetime_form(data):
    """A format with time specifiers yields DATETIME (reference
    strToDateDatetime vs strToDateDate sigs)."""
    import datetime as pydt

    from tiflash_jax.core.block import column_from_numpy

    vals = ["2023-01-31 13:45:06", "1999-12-01 00:00:59", "nope",
            "2023-06-05 23:59:59"]
    block = Block.from_dict({"s": column_from_numpy(vals, dt.STRING)})
    tab = {"s": vals}
    expr = call("str_to_date", col("s"), lit("%Y-%m-%d %H:%i:%s"))
    c = evaluate_expr(expr, block)
    assert c.dtype.kind is TypeKind.DATETIME
    got = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
    want = O.eval_expr_table(expr, tab)
    assert got == want
    assert got[0] == pydt.datetime(2023, 1, 31, 13, 45, 6)
    assert got[2] is None
    # date-only format still yields DATE
    expr2 = call("str_to_date", col("s"), lit("%Y-%m-%d"))
    c2 = evaluate_expr(expr2, block)
    assert c2.dtype.kind is TypeKind.DATE
