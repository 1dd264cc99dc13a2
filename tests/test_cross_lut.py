"""k-ary cross-domain LUT string producers (lpad/rpad/elt/concat_ws with
column arguments) + integer value-domain LUTs (bin/hex over wide-range
low-NDV columns) vs the oracle.

Reference surface: ``Functions/FunctionsString.cpp`` (per-row string
construction) — here replaced by trace-time enumeration over the cross
product of host-knowable argument domains; the corresponding reference
corpus files are ``tests/fullstack-test/expr/{pad,elt,concat_ws,bin,
hex_int,unhex,space}.test``.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block, column_from_numpy
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.expr.compile import evaluate_expr
from tiflash_jax.testing import oracle as O

SCHEMA = {
    "n": dt.INT64.with_nullable(True),
    "s": dt.STRING.with_nullable(True),
    "p": dt.STRING.with_nullable(True),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    table = O.random_pytable(
        rng, 200, SCHEMA, int_range=(-3, 9),
        str_pool=("ab", "", "xyz", "杭州", "0", "12", "-4", "é"),
    )
    return table, O.pytable_to_block(table, SCHEMA)


def check(expr, data):
    table, block = data
    got_col = evaluate_expr(expr, block)
    got = O.block_to_pytable(Block(names=("r",), columns=(got_col,)))["r"]
    want = O.eval_expr_table(expr, table)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (i, g, w, expr)
        if g is not None:
            assert str(g) == str(w), (i, g, w, expr)


CASES = [
    ("lpad_cols", call("lpad", col("s"), col("n"), col("p"))),
    ("rpad_cols", call("rpad", col("s"), col("n"), col("p"))),
    ("lpad_lit_len", call("lpad", col("s"), lit(5), col("p"))),
    ("rpad_empty_pad", call("rpad", col("s"), col("n"), lit(""))),
    ("elt_columns", call("elt", col("n"), col("s"), col("p"), lit("zz"))),
    ("concat_ws_col_sep", call("concat_ws", col("p"), col("s"), lit("L"))),
    ("concat_ws_two_cols",
     call("concat_ws", lit("-"), col("s"), col("p"), lit("t"))),
]


@pytest.mark.parametrize("expr", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cross_lut_functions(expr, data):
    check(expr, data)


def test_unhex_string_and_int(data):
    table = {"h": ["61626364", "GG", None, "E38195E38289", "7", ""],
             "i": [3039, -1, 61626364, None, 313233, 0]}
    schema = {"h": dt.STRING.with_nullable(True),
              "i": dt.INT64.with_nullable(True)}
    blk = O.pytable_to_block(table, schema)
    for c in ("h", "i"):
        e = call("unhex", col(c))
        got_col = evaluate_expr(e, blk)
        got = O.block_to_pytable(
            Block(names=("r",), columns=(got_col,)))["r"]
        want = O.eval_expr_table(e, table)
        assert got == want, (c, got, want)


def test_int_value_domain_lut():
    """bin/hex over a low-NDV column whose [min, max] span is ~2^63 —
    impossible for the range LUT, exact via the value-domain LUT."""
    vals = [0, 1, -1, 2**62, -(2**62), 44, None, 2**62]
    table = {"v": vals}
    blk = O.pytable_to_block(table, {"v": dt.INT64.with_nullable(True)})
    assert blk["v"].domain is not None  # low-NDV column gets a domain
    for fname in ("bin", "hex", "oct"):
        e = call(fname, col("v"))
        got_col = evaluate_expr(e, blk)
        got = O.block_to_pytable(
            Block(names=("r",), columns=(got_col,)))["r"]
        want = O.eval_expr_table(e, table)
        assert got == want, (fname, got, want)


def test_cross_lut_cap_enforced():
    """Two 4096-value domains would need a 16M-combination LUT: the
    engine must refuse, not hang."""
    n = 5000
    rng = np.random.default_rng(7)
    a = rng.integers(0, 400, n)
    b = rng.integers(0, 400, n)
    blk = Block.from_dict({
        "a": column_from_numpy(a.tolist(), dt.INT64),
        "b": column_from_numpy(b.tolist(), dt.INT64),
    })
    with pytest.raises(ValueError):
        evaluate_expr(call("lpad", lit("x"), col("a"),
                           call("bin", col("b"))), blk)
