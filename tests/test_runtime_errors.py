"""Runtime error channel: per-row EvalError lanes reduced to scalar
flags and raised host-side after execution.

Role analog: the reference throws DURING columnar evaluation (e.g.
``TiDB/Decode/JsonBinary.cpp`` parse errors inside CastStringAsJson,
``Functions/FunctionsJson.h``); inside a compiled XLA program nothing
can throw, so the evaluator records per-row error masks, the fragment
compiler reduces live-row masks to scalar flags beside the overflow
flags, and the executor raises ``EngineError`` (code RUNTIME_EVAL)
after the device run (``plan/compiler.py:_drain_eval_errors``).

The VALUE oracle cannot adjudicate errors — the reference corpus's
recorded TiDB errors do (tests/test_reftests.py: cast_as_json.test,
json_unquote.test, json_object.test).  These tests pin the engine-level
contract: WHICH rows error, that FILTERED rows never error, and that
the error wins over a clean result regardless of later operators.
"""

import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.errors import RUNTIME_EVAL, EngineError
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.testing import oracle as O


def _blocks(rows, schema):
    return {"t": O.pytable_to_block(rows, schema)}


def _json_cast_plan(pred=None):
    child = P.TableScan("t")
    if pred is not None:
        child = P.Selection(pred, child)
    return P.Projection({"r": call("cast_as_json", col("s"))}, child)


SCHEMA = {"flag": dt.INT64, "s": dt.STRING.with_nullable(True)}
ROWS = {"flag": [0, 1, 2], "s": [None, "not json", '{"a": 1}']}


def test_cast_invalid_json_errors():
    plan = _json_cast_plan()
    with pytest.raises(EngineError, match="Invalid JSON text") as ei:
        run_query(plan, _blocks(ROWS, SCHEMA))
    assert ei.value.code == RUNTIME_EVAL


def test_cast_invalid_json_filtered_rows_do_not_error():
    # the bad row is filtered out BEFORE the cast: no error (the
    # reference evaluates selected rows only)
    plan = _json_cast_plan(call("not_equals", col("flag"), lit(1)))
    out, _ = run_query(plan, _blocks(ROWS, SCHEMA))
    vals = O.block_to_pytable(out)["r"]
    assert vals == [None, '{"a": 1}']


def test_cast_null_rows_do_not_error():
    rows = {"flag": [0, 1], "s": [None, '"ok"']}
    out, _ = run_query(_json_cast_plan(), _blocks(rows, SCHEMA))
    assert O.block_to_pytable(out)["r"] == [None, '"ok"']


def test_json_depth_cap():
    deep = "[" * 110 + "]" * 110
    rows = {"flag": [0], "s": [deep]}
    with pytest.raises(EngineError, match="maximum depth"):
        run_query(_json_cast_plan(), _blocks(rows, SCHEMA))


def test_json_unquote_invalid_escape_errors():
    rows = {"flag": [0, 1], "s": ['"hello world"', '"hello\\ "']}
    plan = P.Projection({"r": call("json_unquote", col("s"))},
                        P.TableScan("t"))
    with pytest.raises(EngineError,
                       match="document root must not be followed"):
        run_query(plan, _blocks(rows, SCHEMA))
    # drop the bad row: unquote succeeds
    plan_ok = P.Projection(
        {"r": call("json_unquote", col("s"))},
        P.Selection(call("not_equals", col("flag"), lit(1)),
                    P.TableScan("t")))
    out, _ = run_query(plan_ok, _blocks(rows, SCHEMA))
    assert O.block_to_pytable(out)["r"] == ["hello world"]


def test_json_object_null_key_errors():
    rows = {"k": [None, "a"], "v": [1, 2]}
    schema = {"k": dt.STRING.with_nullable(True), "v": dt.INT64}
    plan = P.Projection({"r": call("json_object", col("k"), col("v"))},
                        P.TableScan("t"))
    with pytest.raises(EngineError, match="NULL member names"):
        run_query(plan, _blocks(rows, schema))


def test_json_object_multi_column():
    # k-ary cross-domain LUT: two key columns + int and string values
    rows = {"k1": ["b", "dup"], "v1": [1, 2],
            "k2": ["a", "dup"], "v2": ["x", "last"]}
    schema = {"k1": dt.STRING, "v1": dt.INT64,
              "k2": dt.STRING, "v2": dt.STRING}
    plan = P.Projection(
        {"r": call("json_object", col("k1"), col("v1"),
                   col("k2"), col("v2"))}, P.TableScan("t"))
    out, _ = run_query(plan, _blocks(rows, schema))
    got = O.block_to_pytable(out)["r"]
    assert got == ['{"a": "x", "b": 1}', '{"dup": "last"}']


def test_zero_arg_call_rejected():
    plan = P.Projection({"r": call("least")}, P.TableScan("t"))
    with pytest.raises(EngineError, match="Incorrect parameter count"):
        run_query(plan, _blocks(ROWS, SCHEMA))


def test_error_channel_distributed():
    """The SPMD path: a bad row on ONE shard of an 8-device mesh must
    abort the whole distributed query (flags pmax-reduce across
    devices — mpp/runner.py:_drain_spmd_errors)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from tiflash_jax.mpp.runner import (compile_distributed,
                                        shard_catalog_blocks)
    from tiflash_jax.runtime.errors import (raise_runtime_errors,
                                            split_runtime_errors)

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("d",))
    n = 64
    svals = ['"ok"'] * n
    svals[37] = '"bad\\ "'  # one shard holds the poisoned row
    rows = {"flag": list(range(n)), "s": svals}
    blocks = shard_catalog_blocks(
        {"t": O.pytable_to_block(rows, SCHEMA)}, mesh)
    plan = P.Projection({"r": call("json_unquote", col("s"))},
                        P.TableScan("t"))
    fn = compile_distributed(plan, mesh)
    out, flags = fn(blocks)
    _, rterrs = split_runtime_errors(flags)
    with pytest.raises(EngineError, match="document root"):
        raise_runtime_errors(rterrs)


def test_error_survives_downstream_operators():
    # a TopN after the projection must not swallow the flag: TiFlash
    # aborts the whole query even when LIMIT would drop the bad row
    from tiflash_jax.ops.sort import SortKey

    plan = P.TopN([SortKey("flag")], 1,
                  P.Projection(
                      {"flag": col("flag"),
                       "r": call("json_unquote", col("s"))},
                      P.TableScan("t")))
    rows = {"flag": [0, 1], "s": ['"ok"', '"bad\\ "']}
    with pytest.raises(EngineError):
        run_query(plan, _blocks(rows, SCHEMA))
