"""Session time-zone semantics: TIMESTAMP (tz-aware DATETIME) columns
store UTC and read in the session zone; UNIX_TIMESTAMP/FROM_UNIXTIME
convert through it.  Reference: per-request tz in
``Flash/Coprocessor/DAGContext`` / TiDB ``time_zone``; corpus files
``timestamp_filter.test``, ``year-month-day.test``,
``duplicate_column.test``.
"""

import dataclasses
import datetime

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block
from tiflash_jax.expr.compile import (evaluate_expr, parse_tz_offset_us,
                                      query_timezone)
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.testing import oracle as O

TS = dataclasses.replace(dt.DATETIME, tz_aware=True)


def _ts_block(utc_strings):
    vals = [datetime.datetime.fromisoformat(s) for s in utc_strings]
    blk = O.pytable_to_block({"ts": vals}, {"ts": dt.DATETIME})
    c = blk["ts"]
    return blk.with_column("ts", dataclasses.replace(c, dtype=TS))


def test_parse_tz_offset():
    assert parse_tz_offset_us("+8:00") == 8 * 3600 * 1_000_000
    assert parse_tz_offset_us("-05:30") == -(5 * 3600 + 30 * 60) * 1_000_000
    assert parse_tz_offset_us("UTC") == 0
    assert parse_tz_offset_us("Asia/Shanghai") == 8 * 3600 * 1_000_000


def test_timestamp_column_shifts_at_read():
    blk = _ts_block(["2000-01-01 10:00:00"])
    with query_timezone(parse_tz_offset_us("+8:00")):
        h = evaluate_expr(call("hour", col("ts")), blk)
        eq = evaluate_expr(
            col("ts") == lit("2000-01-01 18:00:00"), blk)
    assert int(h.data[0]) == 18
    assert bool(eq.data[0])
    # plain DATETIME columns never shift
    blk2 = O.pytable_to_block(
        {"d": [datetime.datetime(2000, 1, 1, 10)]}, {"d": dt.DATETIME})
    with query_timezone(parse_tz_offset_us("+8:00")):
        h2 = evaluate_expr(call("hour", col("d")), blk2)
    assert int(h2.data[0]) == 10


def test_unix_timestamp_roundtrip_through_tz():
    # 2021-05-23 11:45:14 UTC = epoch 1621770314
    blk = _ts_block(["2021-05-23 11:45:14"])
    for tz in ("UTC", "+8:00", "-05:30"):
        with query_timezone(parse_tz_offset_us(tz)):
            ut = evaluate_expr(call("unix_timestamp", col("ts")), blk)
            # FROM_UNIXTIME renders the local wall clock of that epoch
            back = evaluate_expr(
                call("hour", call("from_unixtime",
                                  call("unix_timestamp", col("ts")))), blk)
        assert int(ut.data[0]) == 1621770314, tz
        want_hour = {"UTC": 11, "+8:00": 19, "-05:30": 6}[tz]
        assert int(back.data[0]) == want_hour, tz


def test_executor_time_zone_setting():
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.executor import run_query
    from tiflash_jax.runtime.settings import Settings

    blk = _ts_block(["2000-01-01 10:00:00"])
    plan = P.Projection({"h": call("hour", col("ts"))}, P.TableScan("t"))
    out, _ = run_query(plan, {"t": blk},
                       settings=Settings(time_zone="+8:00"))
    assert out.to_pylists()["h"] == [18]
