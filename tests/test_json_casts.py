"""Signature-level pins for the JSON cast family (CastXAsJson /
CastJsonAsX, 14 `ScalarFuncSig`s) and JsonValidJsonSig.

The reference corpus (fullstack-test/expr/cast_as_json.test &co, all
verified by test_reftests.py) exercises these end-to-end; this file pins
each signature individually against hard-coded MySQL/TiDB answers so a
regression names the exact signature.  Reference kernels:
``dbms/src/Functions/FunctionsJson.h`` (CastIntAsJson..CastJsonAsJson),
pushdown list ``dbms/src/Flash/Coprocessor/DAGUtils.cpp``.
"""

import pytest

from tiflash_jax.runtime.errors import EngineError
from tiflash_jax.testing.reftest import RefTestSession


def _session():
    s = RefTestSession()
    s.run_statement(
        "create table tj (j json, i bigint, u bigint unsigned, r double,"
        " d decimal(10,2), s varchar(30), t datetime, du time(3))", None)
    s.run_statement(
        "insert into tj values ('{\"a\": [1, 2]}', -5,"
        " 18446744073709551615, 1.5, 3.25, '[true, null]',"
        " '2020-01-02 03:04:05', '12:30:00.250')", None)
    return s


def _q(s, sql, want_cells):
    # borderless client format: header line, then one TAB-joined line/row
    s.run_statement(sql, ["h"] + ["\t".join(r) for r in want_cells])


CASES = [
    # ---- CastXAsJson (document rendering; temporals carry fsp=6 text)
    ("CastIntAsJson", "select cast(i as json) from tj", [["-5"]]),
    ("CastIntAsJson/unsigned", "select cast(u as json) from tj",
     [["18446744073709551615"]]),
    ("CastRealAsJson", "select cast(r as json) from tj", [["1.5"]]),
    ("CastDecimalAsJson", "select cast(d as json) from tj", [["3.25"]]),
    ("CastStringAsJson", "select cast(s as json) from tj",
     [["[true, null]"]]),
    ("CastTimeAsJson", "select cast(t as json) from tj",
     [['"2020-01-02 03:04:05.000000"']]),
    ("CastDurationAsJson", "select cast(du as json) from tj",
     [['"12:30:00.250000"']]),
    ("CastJsonAsJson", "select cast(j as json) from tj",
     [['{"a": [1, 2]}']]),
    # ---- CastJsonAsX (non-scalar docs -> 0 with warning, TiDB style)
    ("CastJsonAsString", "select cast(j as char) from tj",
     [['{"a": [1, 2]}']]),
    ("CastJsonAsInt", "select cast(cast('123' as json) as signed),"
     " cast(j as signed) from tj", [["123", "0"]]),
    ("CastJsonAsReal", "select cast(cast('1.5' as json) as double),"
     " cast(j as double) from tj", [["1.5", "0"]]),
    ("CastJsonAsDecimal",
     "select cast(cast('1.5' as json) as decimal(10,2)) from tj",
     [["1.50"]]),
    ("CastJsonAsTime", "select cast(cast('\"2020-01-02 03:04:05\"'"
     " as json) as datetime) from tj", [["2020-01-02 03:04:05"]]),
    ("CastJsonAsDuration", "select cast(cast('\"12:30:00\"' as json)"
     " as time) from tj", [["12:30:00"]]),
    # ---- JsonValidJsonSig (a JSON column is always valid JSON)
    ("JsonValidJsonSig", "select json_valid(j) from tj", [["1"]]),
]


@pytest.mark.parametrize("sig,sql,want", CASES, ids=[c[0] for c in CASES])
def test_json_cast_signature(sig, sql, want):
    _q(_session(), sql, want)


def test_cast_invalid_text_as_json_errors_per_row():
    # the reference rejects non-document text at cast time, per row
    # (TiDB Decode/JsonBinary parse error; cast_as_json.test)
    s = _session()
    s.run_statement("insert into tj values (NULL, 0, 0, 0, 0,"
                    " 'not json', '2020-01-01', '00:00:00')", None)
    with pytest.raises(EngineError, match="Invalid JSON text"):
        s.run_statement("select cast(s as json) from tj", ["h"])
