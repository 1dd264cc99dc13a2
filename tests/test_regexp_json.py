"""Regexp + JSON + codec scalar functions: engine (dictionary-LUT) vs the
independent python oracle.  Reference surface:
``Functions/FunctionsRegexpLike.h``, ``FunctionsRegexpReplace.h``,
``Functions/FunctionsJson.h``, ``FunctionsString.h``."""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.expr.compile import evaluate_expr
from tiflash_jax.testing import oracle as O

STR_POOL = (
    "hello world", "Hello World", "", "aXbXc", "2023-04-05",
    "foo123bar456", "line1\nline2", "éàü", "abc,def,ghi", "-1FfZz",
)
JSON_POOL = (
    '{"a": 1, "b": {"c": [10, 20, 30]}, "d": "txt"}',
    '[1, 2, {"x": true}]',
    '"just a string"',
    "42", "3.5", "null", "true",
    "not json at all", "", '{"a": {"b": {"c": 1}}}',
)

SCHEMA = {
    "s": dt.STRING.with_nullable(True),
    "j": dt.STRING.with_nullable(True),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    table = O.random_pytable(rng, 300, {"s": SCHEMA["s"]}, str_pool=STR_POOL)
    jt = O.random_pytable(rng, 300, {"j": SCHEMA["j"]}, str_pool=JSON_POOL)
    table["j"] = jt["j"]
    return table, O.pytable_to_block(table, SCHEMA)


def check(expr, data):
    table, block = data
    got_col = evaluate_expr(expr, block)
    got = O.block_to_pytable(Block(names=("r",), columns=(got_col,)))["r"]
    want = O.eval_expr_table(expr, table)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (i, g, w, expr)
        else:
            assert O._py_eq(g if not isinstance(w, bool) else bool(g), w), (
                i, g, w, expr)


REGEXP_CASES = [
    ("like_basic", call("regexp_like", col("s"), lit("[0-9]+"))),
    ("like_anchor", call("regexp_like", col("s"), lit("^[A-Z]"))),
    ("like_ci", call("regexp_like", col("s"), lit("hello"), lit("i"))),
    ("like_cs_overrides", call("regexp_like", col("s"), lit("hello"), lit("ic"))),
    ("like_multiline", call("regexp_like", col("s"), lit("^line2$"), lit("m"))),
    ("like_dotall", call("regexp_like", col("s"), lit("line1.line2"), lit("n"))),
    ("alias_regexp", call("regexp", col("s"), lit("world"))),
    ("alias_rlike", call("rlike", col("s"), lit("world"))),
    ("instr_basic", call("regexp_instr", col("s"), lit("[0-9]+"))),
    ("instr_occ2", call("regexp_instr", col("s"), lit("[0-9]+"), lit(1), lit(2))),
    ("instr_retopt", call("regexp_instr", col("s"), lit("[0-9]+"), lit(1),
                          lit(1), lit(1))),
    ("instr_pos", call("regexp_instr", col("s"), lit("[a-z]+"), lit(3))),
    ("substr_basic", call("regexp_substr", col("s"), lit("[0-9]+"))),
    ("substr_occ2", call("regexp_substr", col("s"), lit("[0-9]+"), lit(1), lit(2))),
    ("substr_none", call("regexp_substr", col("s"), lit("zzz+"))),
    ("replace_all", call("regexp_replace", col("s"), lit("[0-9]+"), lit("#"))),
    ("replace_occ", call("regexp_replace", col("s"), lit("[aeiou]"), lit("_"),
                         lit(1), lit(2))),
    ("replace_pos", call("regexp_replace", col("s"), lit("[a-z]"), lit("*"),
                         lit(4))),
]


@pytest.mark.parametrize("name,expr", REGEXP_CASES, ids=[c[0] for c in REGEXP_CASES])
def test_regexp(name, expr, data):
    check(expr, data)


JSON_CASES = [
    ("valid", call("json_valid", col("j"))),
    ("type", call("json_type", col("j"))),
    ("depth", call("json_depth", col("j"))),
    ("len_root", call("json_length", col("j"))),
    ("len_path", call("json_length", col("j"), lit("$.b.c"))),
    ("extract_key", call("json_extract", col("j"), lit("$.a"))),
    ("extract_nested", call("json_extract", col("j"), lit("$.b.c[1]"))),
    ("extract_idx", call("json_extract", col("j"), lit("$[2]"))),
    ("extract_scalar_idx0", call("json_extract", col("j"), lit("$[0]"))),
    ("extract_missing", call("json_extract", col("j"), lit("$.zzz"))),
    ("keys_root", call("json_keys", col("j"))),
    ("keys_path", call("json_keys", col("j"), lit("$.b"))),
    ("unquote", call("json_unquote", col("j"))),
    ("unquote_extracted", call("json_unquote",
                               call("json_extract", col("j"), lit("$.d")))),
    ("contains_one", call("json_contains_path", col("j"), lit("one"),
                          lit("$.a"), lit("$.zzz"))),
    ("contains_all", call("json_contains_path", col("j"), lit("all"),
                          lit("$.a"), lit("$.zzz"))),
]


@pytest.mark.parametrize("name,expr", JSON_CASES, ids=[c[0] for c in JSON_CASES])
def test_json(name, expr, data):
    check(expr, data)


CODEC_CASES = [
    ("to_base64", call("to_base64", col("s"))),
    ("b64_roundtrip", call("from_base64", call("to_base64", col("s")))),
    ("from_base64_invalid", call("from_base64", col("s"))),
    ("hex_unhex", call("unhex", call("hex", col("s")))),
    ("unhex_invalid", call("unhex", col("s"))),
    ("quote", call("quote", col("s"))),
    ("soundex", call("soundex", col("s"))),
    ("conv_16_10", call("conv", col("s"), lit(16), lit(10))),
    ("conv_10_2", call("conv", col("s"), lit(10), lit(2))),
    ("conv_neg_base", call("conv", col("s"), lit(10), lit(-16))),
]


@pytest.mark.parametrize("name,expr", CODEC_CASES, ids=[c[0] for c in CODEC_CASES])
def test_codecs(name, expr, data):
    check(expr, data)


def test_regexp_substr_null_validity(data):
    """No-match regexp_substr rows must be NULL (validity), not ''. """
    _, block = data
    got = evaluate_expr(call("regexp_substr", col("s"), lit("world")), block)
    vals = O.block_to_pytable(Block(names=("r",), columns=(got,)))["r"]
    assert any(v is None for v in vals)
    assert any(v == "world" for v in vals)


def test_regexp_column_pattern(data):
    """Column patterns route through the cross-domain LUT (one host
    match per dictionary combo) — every string matches itself."""
    _, block = data
    got = evaluate_expr(call("regexp_like", col("s"), col("s")), block)
    import numpy as np

    vals = np.asarray(got.data)
    live = np.asarray(got.validity) if got.validity is not None else \
        np.ones(len(vals), bool)
    # s regexp s: true unless the string contains regex metachars that
    # break self-matching; with this fixture's pool every live row matches
    import re as _re

    d = block["s"].dictionary or ()
    for i, (v, ok) in enumerate(zip(vals, live)):
        if not ok:
            continue
        s = d[int(np.asarray(block['s'].data)[i])]
        try:
            want = _re.search(s, s) is not None
        except _re.error:
            continue
        assert bool(v) == want, (i, s)
