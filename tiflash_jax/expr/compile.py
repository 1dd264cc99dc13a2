"""Expression evaluation over a Block.

Role analog: ``ExpressionActions::execute``
(``Interpreters/ExpressionActions.cpp:547``) — but instead of an interpreted
action list, evaluation happens *at trace time* inside the enclosing
``jax.jit``: the whole expression tree becomes one fused XLA computation.

String handling: predicates against string literals are rewritten into
dictionary-code space here (the dictionary is static pytree aux data, so it
is available during tracing).  Equality becomes an int compare against a
constant code; ordering uses the order-preserving sorted dictionary; LIKE
and IN evaluate the predicate per dictionary entry on the host and gather a
constant boolean LUT by code — the device analog of the reference's collation
fast paths (``Functions/CollationStringOptimized.cpp``).
"""

from __future__ import annotations

import bisect
import dataclasses
import datetime
import re
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Column
from ..runtime.errors import EngineError, EvalError
from ..core.dtypes import (
    BOOL,
    DATE,
    DataType,
    Decimal,
    FLOAT64,
    INT64,
    STRING,
    TypeKind,
)
from .functions import get_function, cast_column
from .nodes import Call, Cast, ColumnRef, Expr, Literal

_ORDER_CMPS = {"less", "less_or_equals", "greater", "greater_or_equals"}
_EQ_CMPS = {"equals", "not_equals"}

# --- query-clock context ----------------------------------------------------
# NOW()/CURDATE()/RAND() need one stable timestamp per query (the reference
# pins it in the query Context at entry).  The executor sets this contextvar
# around a run; unset, the wall clock is sampled once per evaluation.
import contextvars as _cv
import time as _time

_QUERY_NOW_US: "_cv.ContextVar[Optional[int]]" = _cv.ContextVar(
    "tiflash_query_now_us", default=None
)


def query_now_us() -> int:
    v = _QUERY_NOW_US.get()
    return int(_time.time() * 1_000_000) if v is None else int(v)


_QUERY_TZ_US: "_cv.ContextVar[int]" = _cv.ContextVar(
    "tiflash_query_tz_us", default=0
)


def query_tz_us() -> int:
    """Session time-zone offset (microseconds east of UTC) for the
    current query scope.  TIMESTAMP (tz-aware DATETIME) columns shift by
    this at read; UNIX_TIMESTAMP/FROM_UNIXTIME convert through it.
    Reference: per-request tz in ``Flash/Coprocessor/DAGContext``."""
    return int(_QUERY_TZ_US.get())


class query_timezone:
    """``with query_timezone(offset_us):`` — set the session tz offset
    for the scope (the SET time_zone analog)."""

    def __init__(self, offset_us: int):
        self.us = int(offset_us)

    def __enter__(self):
        self._tok = _QUERY_TZ_US.set(self.us)
        return self

    def __exit__(self, *exc):
        _QUERY_TZ_US.reset(self._tok)
        return False


def parse_tz_offset_us(spec: str) -> int:
    """Session time-zone text ('+8:00', '-05:30', 'UTC', a named zone)
    -> microseconds east of UTC.  Named zones resolve to their CURRENT
    utc offset (no per-row DST model).  Raises ValueError on junk."""
    s = spec.strip().upper()
    if s in ("UTC", "GMT", "SYSTEM", ""):
        return 0
    m = re.match(r"^([+-])(\d{1,2}):(\d{2})$", s)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        return sign * (int(m.group(2)) * 3600
                       + int(m.group(3)) * 60) * 1_000_000
    try:
        import zoneinfo

        off = datetime.datetime.now(
            zoneinfo.ZoneInfo(spec.strip())).utcoffset()
        return int(off.total_seconds() * 1_000_000)
    except Exception:
        raise ValueError(f"unsupported time_zone {spec!r}")


class query_clock:
    """``with query_clock(us):`` — pin NOW()/RAND() for the scope."""

    def __init__(self, us: int):
        self.us = int(us)

    def __enter__(self):
        self._tok = _QUERY_NOW_US.set(self.us)
        return self

    def __exit__(self, *exc):
        _QUERY_NOW_US.reset(self._tok)
        return False


_DATE_ADD_UNITS = {
    "DAY": "days", "WEEK": "weeks", "MONTH": "months", "QUARTER": "quarters",
    "YEAR": "years", "HOUR": "hours", "MINUTE": "minutes",
    "SECOND": "seconds", "MICROSECOND": "microseconds",
}

# EXTRACT composite units: list of (part-fn, decimal weight) summed up
_EXTRACT_PARTS = {
    "YEAR": [("year", 1)],
    "QUARTER": [("quarter", 1)],
    "MONTH": [("month", 1)],
    "WEEK": [("week", 1)],
    "DAY": [("day_of_month", 1)],
    "HOUR": [("hour", 1)],
    "MINUTE": [("minute", 1)],
    "SECOND": [("second", 1)],
    "MICROSECOND": [("microsecond", 1)],
    "YEAR_MONTH": [("year", 100), ("month", 1)],
    "DAY_HOUR": [("day_of_month", 100), ("hour", 1)],
    "DAY_MINUTE": [("day_of_month", 10_000), ("hour", 100), ("minute", 1)],
    "DAY_SECOND": [("day_of_month", 1_000_000), ("hour", 10_000),
                   ("minute", 100), ("second", 1)],
    "HOUR_MINUTE": [("hour", 100), ("minute", 1)],
    "HOUR_SECOND": [("hour", 10_000), ("minute", 100), ("second", 1)],
    "MINUTE_SECOND": [("minute", 100), ("second", 1)],
    "SECOND_MICROSECOND": [("second", 1_000_000), ("microsecond", 1)],
    "MINUTE_MICROSECOND": [("minute", 100_000_000),
                           ("second", 1_000_000), ("microsecond", 1)],
    "HOUR_MICROSECOND": [("hour", 10_000_000_000), ("minute", 100_000_000),
                         ("second", 1_000_000), ("microsecond", 1)],
    "DAY_MICROSECOND": [("day_of_month", 1_000_000_000_000),
                        ("hour", 10_000_000_000), ("minute", 100_000_000),
                        ("second", 1_000_000), ("microsecond", 1)],
}

# cross-product budget for k-ary string-producer LUTs (trace-time python
# evaluations + dictionary size; combinations, never rows)
_CROSS_LUT_CAP = 65536

# MySQL GET_FORMAT table
_GET_FORMAT = {
    ("DATE", "USA"): "%m.%d.%Y", ("DATE", "JIS"): "%Y-%m-%d",
    ("DATE", "ISO"): "%Y-%m-%d", ("DATE", "EUR"): "%d.%m.%Y",
    ("DATE", "INTERNAL"): "%Y%m%d",
    ("DATETIME", "USA"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "JIS"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "ISO"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "EUR"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "INTERNAL"): "%Y%m%d%H%i%s",
    ("TIME", "USA"): "%h:%i:%s %p", ("TIME", "JIS"): "%H:%i:%s",
    ("TIME", "ISO"): "%H:%i:%s", ("TIME", "EUR"): "%H.%i.%s",
    ("TIME", "INTERNAL"): "%H%i%s",
}


def infer_literal_dtype(value) -> DataType:
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT64
    if isinstance(value, float):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    if isinstance(value, datetime.datetime):
        return DataType(TypeKind.DATETIME)
    if isinstance(value, datetime.date):
        return DATE
    from decimal import Decimal as _D

    if isinstance(value, _D):
        return Decimal(18, max(0, -value.as_tuple().exponent))
    if isinstance(value, (list, tuple)):
        from ..core.dtypes import Vector

        return Vector(len(value))
    raise TypeError(f"cannot infer literal type for {value!r}")


def _float_to_decimal(value: float) -> Optional[tuple]:
    """(mantissa, scale) if the float has a short exact decimal repr."""
    s = repr(float(value))
    if "e" in s or "E" in s:
        return None
    if "." in s:
        intpart, frac = s.split(".")
        scale = len(frac)
        if scale > 8:
            return None
        return int(intpart + frac), scale
    return int(s), 0


def _literal_us(value) -> int:
    """Datetime literal (text or date/datetime) -> epoch microseconds,
    keeping any time part."""
    if isinstance(value, str):
        value = datetime.datetime.fromisoformat(value.strip())
    if isinstance(value, datetime.date) and \
            not isinstance(value, datetime.datetime):
        value = datetime.datetime(value.year, value.month, value.day)
    return round((value - datetime.datetime(1970, 1, 1)).total_seconds()
                 * 1_000_000)


def _literal_days(value) -> int:
    if isinstance(value, str):
        # MySQL accepts a full datetime text against a DATE column
        # ('2026-03-01 00:00:00'); the time part truncates
        s = value.strip()
        value = (datetime.datetime.fromisoformat(s).date()
                 if (" " in s or "T" in s)
                 else datetime.date.fromisoformat(s))
    if isinstance(value, datetime.datetime):
        value = value.date()
    return (value - datetime.date(1970, 1, 1)).days


def _doc_depth(v) -> int:
    """Nesting depth of a parsed JSON document (iterative — corpus docs
    go 110 levels deep precisely to probe the 100 cap)."""
    best, stack = 1, [(v, 1)]
    while stack:
        x, k = stack.pop()
        best = max(best, k)
        if isinstance(x, dict):
            stack.extend((c, k + 1) for c in x.values())
        elif isinstance(x, list):
            stack.extend((c, k + 1) for c in x)
    return best


# functions a zero-argument call is legal for (everything else is an
# ERROR 1582 'Incorrect parameter count' at plan time, matching MySQL)
_ZERO_ARG_OK = frozenset({
    "now", "sysdate", "current_timestamp", "curdate", "current_date",
    "curtime", "current_time", "utc_timestamp", "utc_date", "utc_time",
    "unix_timestamp", "rand", "uuid", "pi", "connection_id", "database",
    "version", "found_rows", "last_insert_id", "row_count", "user",
    "current_user", "json_object", "json_array", "uuid_short",
    "release_all_locks", "grouping",
})


class ExprEvaluator:
    """Evaluates a typed expression tree against one Block (at trace time)."""

    def __init__(self, block: Block):
        self.block = block
        self.n = block.capacity
        # runtime error channel: (per-row bool mask, message) collected
        # from host-LUT EvalError entries; the fragment compiler
        # reduces live-row masks to scalar flags (runtime/errors.py)
        self.runtime_errors: list = []

    def evaluate(self, expr: Expr) -> Column:
        if isinstance(expr, ColumnRef):
            c = self.block[expr.name]
            if c.dtype.tz_aware and c.dtype.kind is TypeKind.DATETIME:
                off = query_tz_us()
                if off:
                    # TIMESTAMP reads in session local time (UTC
                    # storage).  The result drops tz_aware: it is now
                    # WALL time, and a downstream plan stage re-reading
                    # the materialized column must not shift again
                    # (timestamp_literal.test scalar subquery)
                    import dataclasses as _dc

                    c = _dc.replace(
                        c, data=c.data + jnp.int64(off),
                        dtype=_dc.replace(c.dtype, tz_aware=False),
                        stats=None if c.stats is None else
                        (c.stats[0] + off, c.stats[1] + off),
                        domain=None if c.domain is None
                        else tuple(int(v) + off for v in c.domain))
            return c
        if isinstance(expr, Literal):
            return self._literal_column(expr, None)
        if isinstance(expr, Call):
            return self._call(expr)
        from .nodes import Cast

        if isinstance(expr, Cast):
            from .functions import cast_column

            src = self.evaluate(expr.arg)
            if expr.target.is_string and not src.dtype.is_string \
                    and src.data.ndim == 1:
                return self._cast_to_string_lut(src, expr.target)
            return cast_column(src, expr.target)
        raise TypeError(f"unknown expression node {expr!r}")

    # -- literals ---------------------------------------------------------

    def _literal_column(self, lit: Literal, context: Optional[Column]) -> Column:
        value = lit.value
        if value is None:
            ref = lit.dtype or (context.dtype if context is not None
                                else INT64)
            dt = ref.with_nullable(True)
            return Column(
                jnp.zeros(self.n, dtype=dt.jnp_dtype),
                jnp.zeros(self.n, dtype=jnp.bool_),
                dt,
            )
        if isinstance(value, (list, tuple)):
            # literal query vector: constant row broadcast (XLA folds it)
            from ..core.dtypes import Vector

            vec = jnp.asarray(np.asarray(value, dtype=np.float32))
            data = jnp.broadcast_to(vec[None, :], (self.n, vec.shape[0]))
            return Column(data, None, Vector(len(value)))
        dt = lit.dtype or infer_literal_dtype(value)
        # contextual re-typing against the other operand
        if context is not None:
            cdt = context.dtype
            if cdt.is_string and isinstance(value, str):
                return self._encode_string_literal(value, context)
            if cdt.kind is TypeKind.DURATION and isinstance(value, str):
                from .functions import parse_mysql_time

                us = parse_mysql_time(value)
                if us is None:  # MySQL: invalid TIME literal -> NULL
                    return Column(jnp.zeros(self.n, dtype=jnp.int64),
                                  jnp.zeros(self.n, dtype=jnp.bool_),
                                  DataType(TypeKind.DURATION, True))
                return Column(jnp.full(self.n, us, dtype=jnp.int64), None,
                              DataType(TypeKind.DURATION))
            if cdt.is_temporal and isinstance(value, (str, datetime.date)):
                if cdt.kind is TypeKind.DATETIME:
                    # full datetime text keeps its time part
                    us = _literal_us(value)
                    return Column(
                        jnp.full(self.n, us, dtype=jnp.int64),
                        None,
                        DataType(TypeKind.DATETIME),
                    )
                days = _literal_days(value)
                return Column(jnp.full(self.n, days, dtype=jnp.int32), None, DATE)
            if cdt.is_numeric and isinstance(value, str):
                # MySQL compares a numeric column against a string
                # constant as DOUBLE (lax numeric-prefix parse;
                # unixTimeStamp.test: decimal(13,3) vs '...314.192')
                import re as _re

                mnum = _re.match(
                    r"\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", value)
                return self._literal_column(
                    Literal(float(mnum.group(0)) if mnum else 0.0),
                    context)
            if cdt.is_decimal and isinstance(value, float):
                md = _float_to_decimal(value)
                if md is not None:
                    m, s = md
                    return Column(
                        jnp.full(self.n, m, dtype=jnp.int64), None,
                        Decimal(18, s), stats=(m, m),
                    )
        if dt.is_string:
            # a constant string column's domain is trivially host-known:
            # its own 1-entry dictionary (same encoding the call path
            # uses via _encode_string_literal; select '518:57:14' and
            # folded constant window aggregates hit this directly)
            return Column(jnp.zeros(self.n, dtype=jnp.int32), None,
                          STRING, dictionary=(str(value),))
        from decimal import Decimal as _D

        if isinstance(value, _D):
            import decimal as _dec

            s = max(0, -value.as_tuple().exponent)
            # scaleb under an explicit wide context: the DEFAULT context
            # is prec-28 and silently rounds >28-digit literal mantissas
            m = int(value.scaleb(s, context=_dec.Context(prec=90)))
            if abs(m) < 2 ** 63:
                return Column(jnp.full(self.n, m, dtype=jnp.int64), None,
                              Decimal(18, s), stats=(m, m))
            # wide constant: L limbs by magnitude (Decimal256 literals)
            p = len(str(abs(m)))
            t = Decimal(min(p, 65), s)
            limbs = []
            mm = m
            for _ in range(t.decimal_limbs - 1):
                limbs.append(mm % 10 ** 18)
                mm //= 10 ** 18
            limbs.append(mm)
            data = jnp.stack(
                [jnp.full(self.n, x, dtype=jnp.int64)
                 for x in reversed(limbs)], axis=-1)
            return Column(data, None, t)
        from ..core.dtypes import ZERO_DT_BASE_US, ZeroDateTime

        if isinstance(value, ZeroDateTime):
            us = ZERO_DT_BASE_US + value.tod_us
            return Column(jnp.full(self.n, us, dtype=jnp.int64), None,
                          DataType(TypeKind.DATETIME), stats=(us, us))
        if isinstance(value, datetime.datetime):
            us = round((value - datetime.datetime(1970, 1, 1))
                       .total_seconds() * 1e6)
            return Column(jnp.full(self.n, us, dtype=jnp.int64), None,
                          DataType(TypeKind.DATETIME), stats=(us, us))
        if isinstance(value, datetime.date):
            days = (value - datetime.date(1970, 1, 1)).days
            return Column(jnp.full(self.n, days, dtype=jnp.int32), None,
                          DATE, stats=(days, days))
        if isinstance(value, int) and not isinstance(value, bool):
            lo, hi = -(2 ** 63), 2 ** 63 - 1
            if dt.kind is TypeKind.UINT64:
                lo, hi = 0, 2 ** 64 - 1
            if not (lo <= value <= hi):
                # beyond-64-bit integer literal (in_expression.test:
                # IN (1, 18446744073709551616)): DECIMAL semantics
                return self._literal_column(Literal(_D(value)), context)
        st = (int(value), int(value)) if isinstance(value, (int, bool)) else None
        return Column(jnp.full(self.n, value, dtype=dt.jnp_dtype), None, dt,
                      stats=st)

    def _encode_string_literal(self, value: str, context: Column) -> Column:
        """Literal -> a constant string column in its OWN 1-entry dictionary.

        The generic call path harmonizes all string arguments into one
        merged dictionary afterwards (``_harmonize_string_args``), so the
        literal needs no knowledge of the context's code space.  (The
        2x/2x-1 rank trick lives only in ``_maybe_string_predicate`` where
        comparisons are rewritten without touching dictionaries.)"""
        del context
        return Column(
            jnp.zeros(self.n, dtype=jnp.int32), None, STRING,
            dictionary=(value,),
        )

    def _harmonize_string_args(self, args):
        """Re-encode all 1-D string arguments into one merged sorted
        dictionary so generic functions (if/coalesce/case_when, comparisons)
        operate in a single order-preserving code space.

        Dictionaries are static trace-time aux data; re-encoding is a host
        LUT + one device gather per differing column.  Returns
        (new_args, merged_dictionary or None)."""
        strs = [
            (i, a) for i, a in enumerate(args)
            if a.dtype.is_string and a.data.ndim == 1
        ]
        if not strs:
            return args, None
        dicts = [a.dictionary or () for _, a in strs]
        if all(d == dicts[0] for d in dicts[1:]):
            return args, dicts[0]
        merged = tuple(sorted(set().union(*map(set, dicts))))
        rank = {s: i for i, s in enumerate(merged)}
        new_args = list(args)
        for (i, a), d in zip(strs, dicts):
            if d == merged:
                continue
            lut = np.fromiter((rank[s] for s in d), dtype=np.int32, count=len(d)) \
                if d else np.zeros(1, dtype=np.int32)
            data = jnp.asarray(lut)[jnp.clip(a.data, 0, len(lut) - 1)]
            new_args[i] = Column(data, a.validity, a.dtype, dictionary=merged,
                                 concat_sep=a.concat_sep)
        return new_args, merged

    def _coerce_mixed_branches(self, name: str, args):
        """MySQL branch-type aggregation for COALESCE/IF/CASE: a string
        branch anywhere makes the RESULT a string, so every non-string
        value branch is rendered to MySQL text over its host-knowable
        domain (coalesce_pushdown.test mixes char/decimal/int/datetime).
        Reference: ``Functions/FunctionsConditional`` getReturnType
        aggregation."""
        if name == "coalesce":
            vals = list(range(len(args)))
        elif name == "if":
            vals = list(range(1, len(args)))
        elif name == "case_when":
            vals = list(range(1, len(args), 2))
            if len(args) % 2 == 1:
                vals.append(len(args) - 1)
        else:
            return args
        picked = [args[i] for i in vals]

        def klass(a):
            if a.dtype.is_string:
                return "s"
            if a.dtype.kind in (TypeKind.DATETIME, TypeKind.DATE,
                                TypeKind.DURATION):
                return "t"
            return "n"

        ks = {klass(a) for a in picked}
        # string anywhere -> string; temporal mixed with numeric ->
        # string too (MySQL aggregates DATETIME+INT to VARCHAR)
        if "s" not in ks and ks != {"t", "n"}:
            return args
        if len(ks) == 1:
            return args
        new_args = list(args)
        for i in vals:
            if not args[i].dtype.is_string:
                new_args[i] = self._cast_to_string_lut(args[i], STRING)
        return new_args

    # -- calls ------------------------------------------------------------

    def _call(self, call: Call) -> Column:
        from .functions import _ALIASES

        # ADDDATE(d, INTERVAL n unit) 3-arg form == DATE_ADD (the 2-arg
        # form aliases to date_add_days below)
        if call.func in ("adddate", "subdate") and len(call.args) == 3:
            call = Call("date_add" if call.func == "adddate" else "date_sub",
                        call.args)
        orig_name = call.func
        name = _ALIASES.get(call.func, call.func)
        if name != call.func:
            call = Call(name, call.args)
        if not call.args and name not in _ZERO_ARG_OK:
            # MySQL rejects empty calls of arg-taking natives at plan
            # time (least_greatest.test / day_of_month.test; ERROR 1582
            # — spelled with the name AS WRITTEN, not the canonical one)
            raise EngineError(
                "Incorrect parameter count in the call to native "
                f"function '{orig_name}'")
        if name == "like":
            return self._like(call)
        if name == "ilike":
            return self._like(call, ci=True)
        if name == "pi":
            import math as _math

            return self._literal_column(Literal(_math.pi), None)
        if name == "elt":
            return self._elt(call)
        if name == "concat_ws":
            return self._concat_ws(call)
        if name in ("lpad", "rpad"):
            left = name == "lpad"

            def pad_fn(s, n, p):
                # TiDB/MySQL: NULL on any NULL arg, negative length, or
                # empty pad when padding is needed; lengths in CHARACTERS
                if s is None or n is None or p is None:
                    return None
                s, p, n = str(s), str(p), _mysql_int_coerce(n)
                if n < 0:
                    return None
                if len(s) >= n:
                    return s[:n]
                if not p:
                    return None
                pad = (p * n)[: n - len(s)]
                return pad + s if left else s + pad

            return self._cross_lut(call.args, pad_fn, name=name)
        if name == "timestampdiff":
            return self._timestampdiff(call)
        if name == "from_unixtime" and len(call.args) == 2:
            fmt = call.args[1]
            if isinstance(fmt, Literal) and fmt.value is None:
                # NULL format string -> NULL (null_literal.test)
                return self._null_string_column()
            if not isinstance(fmt, Literal):
                # the reference rejects non-constant formats at plan
                # time (from_unixtime.test; FunctionsConversion
                # fromUnixTime constant-argument check)
                raise EngineError(
                    "Argument at index 1 for function fromUnixTime "
                    "must be constant")
            return self.evaluate(
                Call("date_format",
                     (Call("from_unixtime", (call.args[0],)), fmt)))
        if name == "date_format":
            return self._date_format(call)
        if name in ("json_array", "json_object"):
            return self._json_build(call)
        if name == "cast_as_json":
            return self._cast_as_json(call)
        if (name in ("round", "truncate", "ceil", "floor")
                and len(call.args) == 2):
            target = self.evaluate(call.args[0])
            if target.dtype.is_decimal:
                d_expr = call.args[1]
                from .functions import (round_decimal_frac,
                                        round_decimal_frac_dynamic)

                if isinstance(d_expr, Literal):
                    return round_decimal_frac(target, int(d_expr.value),
                                              name)
                return round_decimal_frac_dynamic(
                    target, self.evaluate(d_expr), name)
            # non-decimal: generic path (d may even be a column)
        if name in ("date_add", "date_sub"):
            unit_expr = call.args[2]
            assert isinstance(unit_expr, Literal), "DATE_ADD unit must be a literal"
            unit = str(unit_expr.value).upper()
            if unit in _DATE_ADD_UNITS:
                return self._call(Call(f"{name}_{_DATE_ADD_UNITS[unit]}",
                                       call.args[:2]))
            raise ValueError(f"unsupported {name} unit {unit!r}")
        if name == "extract":
            unit_expr = call.args[0]
            assert isinstance(unit_expr, Literal), "EXTRACT unit must be a literal"
            unit = str(unit_expr.value).upper()
            parts = _EXTRACT_PARTS.get(unit)
            if parts is None:
                raise ValueError(f"unsupported EXTRACT unit {unit!r}")
            val = self.evaluate(call.args[1])
            arg_expr = call.args[1]
            if val.dtype.is_string:
                # MySQL implicitly parses the string operand
                # (extract_datetime_from_string.test)
                arg_expr = Cast(call.args[1],
                                DataType(TypeKind.DATETIME, True))
            if val.dtype.kind is TypeKind.DURATION:
                # EXTRACT over TIME is SIGNED (unlike HOUR():
                # EXTRACT(HOUR FROM '-838:34:56') = -838 —
                # extract_duration.test); compose on the magnitude,
                # reapply the sign
                us = val.data.astype(jnp.int64)
                neg = us < 0
                mag = jnp.abs(us)
                pv = {
                    "hour": mag // 3_600_000_000,
                    "minute": (mag // 60_000_000) % 60,
                    "second": (mag // 1_000_000) % 60,
                    "microsecond": mag % 1_000_000,
                    "day_of_month": jnp.zeros_like(mag),
                }
                acc_v = None
                for part_fn, weight in parts:
                    if part_fn not in pv:
                        raise ValueError(
                            f"EXTRACT {unit} over TIME unsupported")
                    term_v = pv[part_fn] * weight
                    acc_v = term_v if acc_v is None else acc_v + term_v
                data = jnp.where(neg, -acc_v, acc_v)
                return Column(data, val.validity,
                              DataType(TypeKind.INT64,
                                       val.dtype.nullable))
            acc = None
            for part_fn, weight in parts:
                term = Call(part_fn, (arg_expr,))
                if weight != 1:
                    term = Call("multiply", (term, Literal(weight)))
                acc = term if acc is None else Call("plus", (acc, term))
            return self._call(acc)
        if name in ("now", "current_timestamp", "sysdate", "utc_timestamp",
                    "localtime", "localtimestamp"):
            us = query_now_us()
            return Column(jnp.full(self.n, us, dtype=jnp.int64), None,
                          DataType(TypeKind.DATETIME))
        if name in ("curdate", "current_date", "utc_date"):
            days = query_now_us() // 86_400_000_000
            return Column(jnp.full(self.n, days, dtype=jnp.int32), None,
                          DataType(TypeKind.DATE))
        if name in ("curtime", "current_time", "utc_time"):
            us = query_now_us()
            tod = us % 86_400_000_000
            hh, rem = divmod(tod // 1_000_000, 3600)
            return self._encode_string_literal(
                "%02d:%02d:%02d" % (hh, rem // 60, rem % 60), None)
        if name == "unix_timestamp" and not call.args:
            return Column(
                jnp.full(self.n, query_now_us() // 1_000_000, dtype=jnp.int64),
                None, DataType(TypeKind.INT64))
        if name in ("version", "database", "schema", "user", "current_user",
                    "connection_id"):
            # MySQL info functions (constant per session); the reference
            # evaluates these in TiDB, but pushed-down plans may still
            # carry them as constants
            if name == "connection_id":
                return Column(jnp.zeros(self.n, dtype=jnp.int64), None,
                              DataType(TypeKind.INT64))
            text = {
                "version": "8.0.11-TiDB-tiflash-jax-0.2",
                "database": "default", "schema": "default",
                "user": "root@%", "current_user": "root@%",
            }[name]
            return self._encode_string_literal(text, None)
        if name == "get_format":
            # MySQL syntax: the first argument is a bare KEYWORD
            # (GET_FORMAT(DATE, ...)) — the parser sees a ColumnRef
            if isinstance(call.args[0], ColumnRef) and \
                    call.args[0].name.upper() in ("DATE", "TIME",
                                                  "DATETIME", "TIMESTAMP"):
                call = Call(name, (Literal(call.args[0].name.upper()),
                                   *call.args[1:]))
            def gf_fn(t, loc):
                if t is None or loc is None:
                    return None
                t = str(t).upper()
                t = "DATETIME" if t == "TIMESTAMP" else t
                return _GET_FORMAT.get((t, str(loc).upper()))

            if all(isinstance(a, Literal) for a in call.args[:2]):
                fmt = gf_fn(call.args[0].value, call.args[1].value)
                if fmt is None:
                    return self._null_string_column()
                return self._encode_string_literal(fmt, None)

            return self._cross_lut(call.args[:2], gf_fn, name="get_format")
        if name == "substring_index":
            def ssi_fn(s, d, n):
                if s is None or d is None or n is None:
                    return None
                s, d, n = str(s), str(d), _mysql_int_coerce(n)
                if not d or n == 0:
                    return ""
                parts = s.split(d)
                return d.join(parts[:n] if n > 0 else parts[n:])

            return self._cross_lut(call.args, ssi_fn,
                                   name="substring_index")
        if name == "rand":
            import jax as _jax

            if call.args:
                seed_expr = call.args[0]
                assert isinstance(seed_expr, Literal), "RAND seed must be a literal"
                seed = int(seed_expr.value)
            else:
                seed = query_now_us() & 0x7FFFFFFF
            key = _jax.random.PRNGKey(seed)
            data = _jax.random.uniform(key, (self.n,), dtype=jnp.float64)
            return Column(data, None, DataType(TypeKind.FLOAT64))
        if name in _STRING_DATE_TRANSFORMS:
            st = self._maybe_string_date_transform(call)
            if st is not None:
                return st
        if name in _INT_STRING_FNS:
            st = self._maybe_int_string_lut(call)
            if st is not None:
                return st
        if name in _STRING_TRANSFORMS:
            st = self._maybe_string_transform(call)
            if st is not None:
                return st
        if name in _STRING_INT_TRANSFORMS:
            st = self._maybe_string_int_transform(call)
            if st is not None:
                return st
        if name in _STRING_BOOL_TRANSFORMS:
            st = self._maybe_string_bool_transform(call)
            if st is not None:
                return st
            if name in ("json_contains_path", "json_contains",
                        "json_valid"):
                # column (non-literal) parameters: k-ary cross-domain
                # LUT over the argument dictionaries
                # (json_contains_path.test drives col_type/col_path
                # from tables)
                if name == "json_valid" and len(call.args) == 1:
                    a0 = self.evaluate(call.args[0])
                    if not a0.dtype.is_string:
                        # non-string types can never hold JSON: constant
                        # 0, never NULL (json_valid.test col_others)
                        fnv = get_function(name)
                        return fnv.evaluate([a0], fnv.infer([a0.dtype]))
                fn0 = _STRING_BOOL_TRANSFORMS[name][1]

                def jc(*vs):
                    if name == "json_contains_path":
                        # NULL paths participate in the short-circuit
                        if vs[0] is None or vs[1] is None:
                            return None
                        return fn0(str(vs[0]), str(vs[1]), *vs[2:])
                    if any(v is None for v in vs):
                        return None
                    return fn0(*[str(v) for v in vs])

                from ..core.dtypes import BOOL as _BOOL

                return self._cross_lut_value(call.args, jc,
                                             name=name, out_dtype=_BOOL)
            if name == "regexp_like":
                # column pattern: cross-domain LUT (subject x pattern)
                rl = _STRING_BOOL_TRANSFORMS[name][1]

                def rl_fn(*vs):
                    if any(v is None for v in vs):
                        return None
                    return rl(str(vs[0]), *[str(v) for v in vs[1:]])

                from ..core.dtypes import BOOL as _BOOL

                return self._cross_lut_value(call.args, rl_fn,
                                             name=name, out_dtype=_BOOL)
        # string predicate against literal(s): rewrite to code space
        if name in (_ORDER_CMPS | _EQ_CMPS | {"in"}):
            rewritten = self._maybe_string_predicate(call)
            if rewritten is not None:
                return rewritten
        # evaluate non-literals first so literals get operand context
        ctx: Optional[Column] = None
        evaluated: Dict[int, Column] = {}
        for i, a in enumerate(call.args):
            if not isinstance(a, Literal):
                evaluated[i] = self.evaluate(a)
                if ctx is None:
                    ctx = evaluated[i]
        # string literals must take a STRING operand as context (the first
        # operand may be e.g. the bool condition of if())
        str_ctx = next(
            (c for c in evaluated.values() if c.dtype.is_string), None
        )
        for i, a in enumerate(call.args):
            if isinstance(a, Literal):
                use = str_ctx if isinstance(a.value, str) and str_ctx is not None else ctx
                evaluated[i] = self._literal_column(a, use)
        args = [evaluated[i] for i in range(len(call.args))]
        args = self._coerce_mixed_branches(name, args)
        args, merged_dict = self._harmonize_string_args(args)
        fn = get_function(name)
        out = fn.infer([a.dtype for a in args])
        res = fn.evaluate(args, out)
        if res.dtype.is_string and res.dictionary is None and merged_dict is not None:
            res = Column(res.data, res.validity, res.dtype, dictionary=merged_dict,
                         concat_sep=res.concat_sep)
        if res.stats is None:
            from .functions import propagate_stats

            st = propagate_stats(name, args, out)
            if st is not None:
                res = Column(res.data, res.validity, res.dtype,
                             res.dictionary, concat_sep=res.concat_sep,
                             stats=st)
        return res

    def _maybe_string_predicate(self, call: Call) -> Optional[Column]:
        """Comparisons/IN where one side is a string column and the other(s)
        are string literals: map into dictionary-code space.

        Sorted dictionaries make codes order-preserving, so:
          - member literal -> its exact rank (all six comparisons exact)
          - non-member literal -> doubled-code trick: column codes * 2,
            literal 2*bisect_left - 1 sits strictly between neighbors.
        """
        name = call.func
        args = call.args
        lit_idx = [i for i, a in enumerate(args) if isinstance(a, Literal)
                   and isinstance(a.value, str)]
        col_idx = [i for i, a in enumerate(args) if i not in lit_idx]
        if not lit_idx or len(col_idx) != 1:
            return None
        target = self.evaluate(args[col_idx[0]])
        if not target.dtype.is_string or target.dtype.mysql_json:
            # JSON dictionaries rank by JSON precedence, not bytes —
            # the bisect code-space tricks below assume lexicographic
            return None
        d = target.dictionary or ()
        intd = DataType(TypeKind.INT32, target.dtype.nullable)

        def code_of(s: str):
            lo = bisect.bisect_left(d, s)
            member = lo < len(d) and d[lo] == s
            return lo, member

        if name == "in":
            codes = []
            for i in lit_idx:
                lo, member = code_of(args[i].value)
                if member:
                    codes.append(lo)
            if not codes:
                return Column(
                    jnp.zeros(self.n, dtype=jnp.bool_), target.validity,
                    DataType(TypeKind.BOOL, target.dtype.nullable),
                )
            acc = None
            for c in codes:
                eq = target.data == jnp.int32(c)
                acc = eq if acc is None else (acc | eq)
            return Column(acc, target.validity,
                          DataType(TypeKind.BOOL, target.dtype.nullable))

        lo, member = code_of(args[lit_idx[0]].value)
        if member:
            lhs_data = target.data
            lit_code = lo
        else:
            lhs_data = target.data.astype(jnp.int32) * 2
            lit_code = 2 * lo - 1
        # preserve argument order (col op lit vs lit op col)
        lhs = Column(lhs_data, target.validity, intd)
        rhs = Column(jnp.full(self.n, lit_code, dtype=jnp.int32), None,
                     DataType(TypeKind.INT32))
        pair = [lhs, rhs] if col_idx[0] == 0 else [rhs, lhs]
        fn = get_function(name)
        out = fn.infer([c.dtype for c in pair])
        return fn.evaluate(pair, out)

    def _maybe_string_transform(self, call: Call) -> Optional[Column]:
        """str-column + literal params -> dictionary LUT transform."""
        if not call.args:
            return None
        rest = call.args[1:]
        if not all(isinstance(a, Literal) for a in rest):
            return None
        if isinstance(call.args[0], Literal):
            # constant fold: every argument is a literal
            fn = _STRING_TRANSFORMS[call.func]
            params = [a.value for a in rest]
            v0 = call.args[0].value
            if v0 is None or any(p is None for p in params):
                return Column(jnp.zeros(self.n, dtype=jnp.int32),
                              jnp.zeros(self.n, dtype=jnp.bool_),
                              STRING.with_nullable(True), ("",))
            res = fn(str(v0), *params)
            if res is None:
                return Column(jnp.zeros(self.n, dtype=jnp.int32),
                              jnp.zeros(self.n, dtype=jnp.bool_),
                              STRING.with_nullable(True), ("",))
            return self._encode_string_literal(str(res), None)
        target = self.evaluate(call.args[0])
        if not target.dtype.is_string:
            return None
        from .functions import _map_string_to_string

        fn = _STRING_TRANSFORMS[call.func]
        params = [a.value for a in rest]
        if any(p is None for p in params):  # MySQL: NULL param -> NULL
            return Column(jnp.zeros(self.n, dtype=jnp.int32),
                          jnp.zeros(self.n, dtype=jnp.bool_),
                          STRING.with_nullable(True), ("",))
        return _map_string_to_string(target, lambda s: fn(s, *params),
                                     errors=self.runtime_errors)

    def _maybe_string_int_transform(self, call: Call) -> Optional[Column]:
        """str-column + literal params -> int via dictionary LUT
        (instr/locate/strcmp/find_in_set/field)."""
        col_idx, fn = _STRING_INT_TRANSFORMS[call.func]
        if col_idx >= len(call.args):
            return None
        lits = [a for i, a in enumerate(call.args) if i != col_idx]
        if not all(isinstance(a, Literal) for a in lits):
            return None
        target = self.evaluate(call.args[col_idx])
        if not target.dtype.is_string:
            return None
        from .functions import _map_string_to_int

        params = [a.value for a in lits]
        if any(p is None for p in params):  # MySQL: NULL param -> NULL
            from ..core.dtypes import INT64 as _I64

            return Column(jnp.zeros(self.n, dtype=jnp.int64),
                          jnp.zeros(self.n, dtype=jnp.bool_),
                          _I64.with_nullable(True))
        out = _map_string_to_int(target, lambda s: fn(s, *params))
        if call.func in _NEVER_NULL_FNS and out.validity is not None:
            # is_ipv4/is_ipv6 return 0 for NULL input (MySQL)
            out = Column(jnp.where(out.validity, out.data,
                                   jnp.zeros_like(out.data)),
                         None, out.dtype.with_nullable(False))
        return out

    def _maybe_string_bool_transform(self, call: Call) -> Optional[Column]:
        """str-column + literal params -> bool via dictionary LUT
        (regexp_like / json_valid)."""
        col_idx, fn = _STRING_BOOL_TRANSFORMS[call.func]
        if col_idx >= len(call.args):
            return None
        lits = [a for i, a in enumerate(call.args) if i != col_idx]
        if not all(isinstance(a, Literal) for a in lits):
            return None
        target = self.evaluate(call.args[col_idx])
        if not target.dtype.is_string:
            return None
        from .functions import _map_string_to_int

        params = [a.value for a in lits]
        if any(p is None for p in params) \
                and call.func not in _NEVER_NULL_FNS:
            # MySQL: NULL pattern/param -> NULL result
            from ..core.dtypes import BOOL as _BOOL

            return Column(jnp.zeros(self.n, dtype=jnp.bool_),
                          jnp.zeros(self.n, dtype=jnp.bool_),
                          _BOOL.with_nullable(True))
        out = _map_string_to_int(target, lambda s: fn(s, *params),
                                 kind=TypeKind.BOOL)
        if call.func in _NEVER_NULL_FNS and out.validity is not None:
            out = Column(jnp.where(out.validity, out.data,
                                   jnp.zeros_like(out.data)),
                         None, out.dtype.with_nullable(False))
        return out

    def _maybe_string_date_transform(self, call: Call) -> Optional[Column]:
        """str-column + literal params -> DATE via dictionary LUT
        (str_to_date); a format with time specifiers selects the DATETIME
        result instead (reference strToDateDate vs strToDateDatetime)."""
        fn = _STRING_DATE_TRANSFORMS[call.func]
        rest = call.args[1:]
        if not all(isinstance(a, Literal) for a in rest):
            return None
        target = self.evaluate(call.args[0])
        if not target.dtype.is_string:
            return None
        params = [a.value for a in rest]
        if (call.func == "str_to_date" and params
                and _rj.format_has_time(str(params[0]))):
            from .functions import _map_string_to_datetime

            return _map_string_to_datetime(
                target, lambda s: _rj.str_to_datetime(s, *params))
        from .functions import _map_string_to_date

        return _map_string_to_date(target, lambda s: fn(s, *params))

    def _elt(self, call: Call) -> Column:
        """MySQL ELT(n, s1, s2, ...): int index column + string literals;
        out-of-range n -> NULL.  Device side is one clipped gather.
        Column items (or a wide-domain index) route to the k-ary
        cross-domain LUT."""
        if not all(isinstance(a, Literal) and isinstance(a.value, str)
                   for a in call.args[1:]):
            def elt_fn(n, *items):
                if n is None:
                    return None
                n = int(n)
                if not (1 <= n <= len(items)):
                    return None
                return items[n - 1]

            return self._cross_lut(call.args, elt_fn, name="elt")
        n_col = self.evaluate(call.args[0])
        items = [a.value for a in call.args[1:]]
        d = tuple(sorted(set(items)))
        rank = {s: i for i, s in enumerate(d)}
        lut = jnp.asarray(np.array([rank[s] for s in items], dtype=np.int32))
        idx = n_col.data.astype(jnp.int64)
        ok = (idx >= 1) & (idx <= len(items))
        data = lut[jnp.clip(idx - 1, 0, len(items) - 1).astype(jnp.int32)]
        v = ok if n_col.validity is None else (n_col.validity & ok)
        return Column(data, v, STRING.with_nullable(True), d)

    def _concat_ws(self, call: Call) -> Column:
        """CONCAT_WS(sep, ...): literal separator, at most one string
        column among the pieces (dictionary LUT); NULL pieces are skipped
        (MySQL), so a NULL column value yields the literals-only join."""
        def ws_fn(sep, *pieces):
            # MySQL: NULL separator -> NULL; NULL pieces are skipped
            if sep is None:
                return None
            return str(sep).join(str(p) for p in pieces if p is not None)

        sep_a = call.args[0]
        if not (isinstance(sep_a, Literal) and isinstance(sep_a.value, str)):
            return self._cross_lut(call.args, ws_fn, name="concat_ws")
        sep = sep_a.value
        col_idx = [i for i, a in enumerate(call.args[1:], start=1)
                   if not isinstance(a, Literal)]
        lits = {i: a.value for i, a in enumerate(call.args[1:], start=1)
                if isinstance(a, Literal)}
        if len(col_idx) != 1:
            return self._cross_lut(call.args, ws_fn, name="concat_ws")
        target = self.evaluate(call.args[col_idx[0]])
        if not target.dtype.is_string:
            raise ValueError("CONCAT_WS column piece must be a string")
        ci = col_idx[0]
        d = target.dictionary or ()

        def joined(col_val):
            pieces = []
            for i in range(1, len(call.args)):
                v = col_val if i == ci else lits[i]
                if v is not None:
                    pieces.append(str(v))
            return sep.join(pieces)

        mapped = [joined(s) for s in d]
        null_case = joined(None)
        new_dict = tuple(sorted(set(mapped) | {null_case}))
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.array([rank[m] for m in mapped] or [rank[null_case]],
                         dtype=np.int32)
        data = jnp.asarray(table)[jnp.clip(target.data, 0, len(table) - 1)]
        if target.validity is not None:
            data = jnp.where(target.validity, data,
                             jnp.int32(rank[null_case]))
        return Column(data, None, STRING, new_dict)

    def _timestampdiff(self, call: Call) -> Column:
        """TIMESTAMPDIFF(unit, a, b): complete units from a to b
        (MySQL truncation toward zero; month family adjusts on
        day/time-of-day comparison)."""
        unit_a = call.args[0]
        assert isinstance(unit_a, Literal), "TIMESTAMPDIFF unit must be a literal"
        unit = str(unit_a.value).upper()
        if any(isinstance(x, Literal) and x.value is None
               for x in call.args[1:]):
            # NULL operand -> NULL (null_literal.test)
            return Column(jnp.zeros(self.n, dtype=jnp.int64),
                          jnp.zeros(self.n, dtype=jnp.bool_),
                          DataType(TypeKind.INT64, True))
        a = self.evaluate(call.args[1])
        b = self.evaluate(call.args[2])
        from .functions import _and_validity, _civil_from_days, _date_days

        def to_us(c):
            if c.dtype.kind is TypeKind.DATE:
                return c.data.astype(jnp.int64) * 86_400_000_000
            return c.data.astype(jnp.int64)

        va = _and_validity([a, b])
        if unit in ("MONTH", "QUARTER", "YEAR"):
            da, db = _date_days(a), _date_days(b)
            ya, ma, dda = _civil_from_days(da)
            yb, mb, ddb = _civil_from_days(db)
            ta = to_us(a) - da * 86_400_000_000
            tb = to_us(b) - db * 86_400_000_000
            m = (yb - ya) * 12 + (mb - ma)
            b_early = (ddb < dda) | ((ddb == dda) & (tb < ta))
            b_late = (ddb > dda) | ((ddb == dda) & (tb > ta))
            m = jnp.where((m > 0) & b_early, m - 1, m)
            m = jnp.where((m < 0) & b_late, m + 1, m)
            q = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}[unit]
            data = jnp.sign(m) * (jnp.abs(m) // q)
        else:
            unit_us = {
                "MICROSECOND": 1, "SECOND": 1_000_000,
                "MINUTE": 60_000_000, "HOUR": 3_600_000_000,
                "DAY": 86_400_000_000, "WEEK": 7 * 86_400_000_000,
            }[unit]
            diff = to_us(b) - to_us(a)
            data = jnp.sign(diff) * (jnp.abs(diff) // unit_us)
        return Column(data, va, DataType(TypeKind.INT64,
                                         a.dtype.nullable or b.dtype.nullable))

    def _date_format(self, call: Call) -> Column:
        """DATE_FORMAT(date_col, fmt): formatted-string LUT over the
        column's PROVEN day range (MinMaxIndex stats) — the device answer to
        per-row formatting; device side is one gather."""
        target = self.evaluate(call.args[0])
        fmt_a = call.args[1]
        assert isinstance(fmt_a, Literal), "DATE_FORMAT needs a literal format"
        if fmt_a.value is None:
            return self._null_string_column()  # NULL format -> NULL
        if target.dtype.kind is not TypeKind.DATE:
            raise ValueError("DATE_FORMAT supports DATE columns (datetime: "
                             "cast to date first)")
        if target.stats is None:
            raise ValueError("DATE_FORMAT needs column range stats")
        lo, hi = int(target.stats[0]), int(target.stats[1])
        if hi - lo > 200_000:
            raise ValueError("DATE_FORMAT day range too wide for LUT")
        from .regexp_json import format_mysql_date

        epoch = datetime.date(1970, 1, 1)
        fmt = fmt_a.value
        mapped = [
            format_mysql_date(epoch + datetime.timedelta(days=day), fmt)
            for day in range(lo, hi + 1)
        ]
        new_dict = tuple(sorted(set(mapped))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.array([rank[m] for m in mapped] or [0], dtype=np.int32)
        idx = jnp.clip(target.data.astype(jnp.int64) - lo, 0, len(table) - 1)
        data = jnp.asarray(table)[idx.astype(jnp.int32)]
        return Column(data, target.validity,
                      STRING.with_nullable(target.dtype.nullable), new_dict)

    def _maybe_int_string_lut(self, call: Call) -> Optional[Column]:
        """int column -> string via a LUT over the PROVEN value range
        (MinMaxIndex stats) — BIN/OCT/HEX/FORMAT for integer arguments.
        Returns None for string arguments (hex falls through to the
        dictionary transform) or unbounded ranges."""
        rest = call.args[1:]
        if not all(isinstance(a, Literal) for a in rest):
            return None
        target = self.evaluate(call.args[0])
        if (not (target.dtype.is_integer or target.dtype.is_float
                 or (target.dtype.is_decimal and target.data.ndim == 1))
                or (target.stats is None and target.domain is None)):
            return None
        if target.stats is None and not target.dtype.is_integer:
            return None  # float/decimal conversions below need range stats
        fn_override = None
        if target.dtype.is_decimal:
            from .functions import _div_round_half_up, _pow10
            from ..core.dtypes import INT64 as _I64

            if call.func == "format":
                # FORMAT keeps the fraction (999.9999 with d=10 is
                # '999.9999000000', NOT '1,000.0000000000'): LUT over
                # the exact MANTISSA domain — format.test
                import decimal as _dec

                sc = target.dtype.scale
                base = _INT_STRING_FNS["format"]
                ctx90 = _dec.Context(prec=90)

                def fn_override(v, *p, _b=base, _s=sc, _c=ctx90):
                    return _b(_dec.Decimal(int(v)).scaleb(-_s, _c), *p)

                target = Column(target.data.astype(jnp.int64),
                                target.validity,
                                _I64.with_nullable(target.dtype.nullable),
                                stats=target.stats, domain=target.domain)
            else:
                q = 10 ** target.dtype.scale
                data = _div_round_half_up(target.data.astype(jnp.int64),
                                          _pow10(target.dtype.scale))
                st = (int(target.stats[0]) // q - 1,
                      int(target.stats[1]) // q + 1)
                target = Column(data, target.validity,
                                _I64.with_nullable(target.dtype.nullable),
                                stats=st)
        if target.dtype.is_float:
            # MySQL rounds the numeric argument (HEX(255.5) = '100')
            x = target.data.astype(jnp.float64)
            data = jnp.where(x >= 0, jnp.floor(x + 0.5),
                             jnp.ceil(x - 0.5)).astype(jnp.int64)
            from ..core.dtypes import INT64 as _I64

            target = Column(data, target.validity,
                            _I64.with_nullable(target.dtype.nullable),
                            stats=target.stats)
        fn = fn_override or _INT_STRING_FNS[call.func]
        params = [a.value for a in rest]
        span_ok = (target.stats is not None
                   and int(target.stats[1]) - int(target.stats[0]) <= 65536)
        if span_ok:
            lo, hi = int(target.stats[0]), int(target.stats[1])
            dom_vals = range(lo, hi + 1)
            idx = jnp.clip(target.data.astype(jnp.int64) - lo,
                           0, hi - lo)
        elif target.domain is not None and len(target.domain) <= 65536:
            # exact value-set LUT (the numeric dictionary): covers columns
            # whose [min, max] span is astronomically wider than their NDV
            dom_vals = [int(v) for v in target.domain]
            # the column's own physical dtype (uint64 domains overflow int64)
            dom = jnp.asarray(np.array(dom_vals, dtype=target.data.dtype))
            idx = jnp.clip(
                jnp.searchsorted(dom, target.data, method="sort"),
                0, len(dom_vals) - 1).astype(jnp.int64)
        else:
            raise ValueError(
                f"{call.func} over an integer column needs a proven value "
                "range <= 65536 (dictionary LUT)"
            )
        mapped = [fn(v, *params) for v in dom_vals]
        nulls = np.array([m is None for m in mapped] or [False])
        mapped = ["" if m is None else m for m in mapped]
        new_dict = tuple(sorted(set(mapped))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.array([rank[m] for m in mapped] or [0], dtype=np.int32)
        idx = jnp.minimum(idx, len(table) - 1)
        data = jnp.asarray(table)[idx.astype(jnp.int32)]
        validity, nullable = target.validity, target.dtype.nullable
        if nulls.any():  # fn returned None for some in-range values -> NULL
            ok = jnp.asarray(~nulls)[idx.astype(jnp.int32)]
            validity = ok if validity is None else (validity & ok)
            nullable = True
        return Column(data, validity,
                      STRING.with_nullable(nullable), new_dict)

    def _cast_to_string_lut(self, src: Column, target,
                            render=None) -> Column:
        """CAST(x AS CHAR) for non-string x: MySQL text rendering over
        the column's host-knowable domain (value domain / narrow range
        stats / bool), one gather.  Reference: CastIntAsString &co,
        ``Functions/FunctionsConversion.h``."""
        vals, codes = self._col_code_space(src)
        if render is None and src.dtype.kind is TypeKind.FLOAT32:
            # CAST(FLOAT AS CHAR) renders at float32 precision: shortest
            # text that round-trips the f32 value (LENGTH(float 1.3)=3).
            # JSON casts keep the exact widened double instead.
            vals = [None if v is None else float(str(np.float32(v)))
                    for v in vals]
        render = render or _mysql_value_text
        mapped = [None if v is None else render(v) for v in vals]
        mapped = self._sift_lut_errors(
            mapped, jnp.clip(codes, 0, len(mapped) - 1))
        nulls = np.array([m is None for m in mapped] or [False])
        strs = ["" if m is None else m for m in mapped]
        new_dict = tuple(sorted(set(strs))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.asarray([rank[s] for s in strs] or [0], dtype=np.int32)
        idx = jnp.clip(codes, 0, len(table) - 1)
        data = jnp.asarray(table)[idx]
        validity, nullable = src.validity, src.dtype.nullable
        if nulls.any():
            ok = jnp.asarray(~nulls)[idx]
            validity = ok if validity is None else (validity & ok)
            nullable = True
        return Column(data, validity, target.with_nullable(nullable),
                      new_dict)

    def _null_string_column(self) -> Column:
        """All-NULL string column (MySQL NULL result of a string fn)."""
        return Column(jnp.zeros(self.n, dtype=jnp.int32),
                      jnp.zeros(self.n, dtype=jnp.bool_),
                      STRING.with_nullable(True), ("",))

    # -- k-ary cross-domain LUT -------------------------------------------

    def _arg_code_space(self, arg):
        """One LUT axis for a k-ary string producer: returns
        ``(host_values, codes)`` where ``host_values`` is a python list
        (last slot None when the column is nullable — NULL inputs route
        there) and ``codes`` a per-row int32 index into it; literals get
        a 1-element axis with codes None.  Raises ValueError when the
        argument has no host-enumerable domain."""
        if isinstance(arg, Literal):
            return [arg.value], None
        return self._col_code_space(self.evaluate(arg))

    def _col_code_space(self, c: Column):
        """(host_values, per-row int32 codes) for an already-evaluated
        column — see _arg_code_space."""
        if c.dtype.is_string:
            vals = list(c.dictionary or ()) or [""]
            codes = jnp.clip(c.data.astype(jnp.int32), 0, len(vals) - 1)
        elif c.dtype.kind is TypeKind.BOOL:
            vals = [0, 1]
            codes = c.data.astype(jnp.int32)
        elif c.domain is not None and len(c.domain) <= _CROSS_LUT_CAP \
                and c.data.ndim == 1:
            # exact value-domain axis: domain holds PHYSICAL values; map
            # them to the host values ``fn`` should see per logical type
            if c.dtype.is_decimal:
                from decimal import Decimal as _D

                vals = [_D(int(x)).scaleb(-c.dtype.scale)
                        for x in c.domain]
            elif c.dtype.kind is TypeKind.DATE:
                epoch = datetime.date(1970, 1, 1)
                vals = [epoch + datetime.timedelta(days=int(x))
                        for x in c.domain]
            elif c.dtype.kind is TypeKind.DATETIME:
                epoch0 = datetime.datetime(1970, 1, 1)
                vals = [epoch0 + datetime.timedelta(microseconds=int(x))
                        for x in c.domain]
            elif c.dtype.is_float:
                vals = [float(x) for x in c.domain]
            else:
                vals = [int(x) for x in c.domain]
            dom = jnp.asarray(np.array(list(c.domain),
                                       dtype=c.data.dtype))
            codes = jnp.clip(
                jnp.searchsorted(dom, c.data, method="sort"),
                0, len(vals) - 1).astype(jnp.int32)
        elif c.dtype.is_integer and c.stats is not None and \
                int(c.stats[1]) - int(c.stats[0]) < 4096:
            lo = int(c.stats[0])
            vals = list(range(lo, int(c.stats[1]) + 1))
            codes = jnp.clip(c.data.astype(jnp.int64) - lo, 0,
                             len(vals) - 1).astype(jnp.int32)
        else:
            raise ValueError(
                "cross-domain LUT needs a host-knowable value set "
                "(dictionary / value domain / narrow range stats) — "
                f"got {c.dtype}")
        if c.validity is not None:
            vals = vals + [None]
            codes = jnp.where(c.validity, codes, jnp.int32(len(vals) - 1))
        return vals, codes

    def _cross_codes(self, args, name: str):
        """Shared cross-LUT front half: per-argument axes + the fused
        per-row combination code (row-major, literal axes are size-1)."""
        axes = [self._arg_code_space(a) for a in args]
        total = 1
        for vals, _ in axes:
            total *= len(vals)
        if total > _CROSS_LUT_CAP:
            raise ValueError(f"{name}: cross-domain LUT size {total} "
                             f"exceeds {_CROSS_LUT_CAP}")
        code = None
        for vals, codes in axes:
            k = len(vals)
            if code is not None and k > 1:
                code = code * jnp.int32(k)
            if codes is not None:
                code = codes if code is None else code + codes
        if code is None:  # all-literal call
            code = jnp.zeros(self.n, dtype=jnp.int32)
        return axes, code

    def _sift_lut_errors(self, mapped, idx, base_validity=None):
        """Runtime error channel: split ``EvalError`` entries out of a
        LUT table.  Per distinct message, records a per-row bool mask
        (rows whose code lands on an error entry) in
        ``self.runtime_errors``; returns ``mapped`` with errors replaced
        by None so the value path stays well-formed.  ``base_validity``
        masks rows whose NULL input makes the code slot meaningless."""
        if not any(isinstance(m, EvalError) for m in mapped):
            return mapped
        by_msg: Dict[str, list] = {}
        for i, m in enumerate(mapped):
            if isinstance(m, EvalError):
                by_msg.setdefault(m.message, []).append(i)
        for msg, idxs in by_msg.items():
            tbl = np.zeros(len(mapped), dtype=bool)
            tbl[idxs] = True
            mask = jnp.asarray(tbl)[idx]
            if base_validity is not None:
                mask = mask & base_validity
            self.runtime_errors.append((mask, msg))
        return [None if isinstance(m, EvalError) else m for m in mapped]

    def _cross_lut_value(self, args, fn, *, name: str,
                         out_dtype: DataType) -> Column:
        """Cross-domain LUT with a NON-string result (bool/int):
        LIKE/ILIKE/regexp with column patterns &co."""
        import itertools

        axes, code = self._cross_codes(args, name)
        mapped = [fn(*combo) for combo in
                  itertools.product(*[v for v, _ in axes])]
        mapped = self._sift_lut_errors(
            mapped, jnp.clip(code, 0, len(mapped) - 1))
        nulls = np.array([m is None for m in mapped] or [False])
        arr = np.asarray([0 if m is None else m for m in mapped] or [0],
                         dtype=out_dtype.physical)
        idx = jnp.clip(code, 0, len(arr) - 1)
        data = jnp.asarray(arr)[idx]
        validity, nullable = None, False
        if nulls.any():
            validity = jnp.asarray(~nulls)[idx]
            nullable = True
        return Column(data, validity, out_dtype.with_nullable(nullable))

    def _cross_lut(self, args, fn, *, name: str) -> Column:
        """k-ary string producer over the cross product of the arguments'
        host-enumerable domains (dictionary / int value domain / narrow
        range stats): one python ``fn`` call per domain COMBINATION
        (never per row), one fused int32 code, one gather.  The device
        answer to per-row string construction for multi-column forms —
        NULL semantics live entirely in ``fn`` (it sees python None and
        returns None for NULL).  Reference: per-row vectorized string
        ops, ``Functions/FunctionsString.cpp`` — here replaced by
        trace-time enumeration."""
        import itertools

        axes, code = self._cross_codes(args, name)
        mapped = [fn(*combo) for combo in
                  itertools.product(*[v for v, _ in axes])]
        mapped = self._sift_lut_errors(
            mapped, jnp.clip(code, 0, len(mapped) - 1))
        nulls = np.array([m is None for m in mapped] or [False])
        strs = ["" if m is None else str(m) for m in mapped]
        new_dict = tuple(sorted(set(strs))) or ("",)
        rank = {s: i for i, s in enumerate(new_dict)}
        table = np.asarray([rank[s] for s in strs] or [0], dtype=np.int32)
        idx = jnp.clip(code, 0, len(table) - 1)
        data = jnp.asarray(table)[idx]
        validity = None
        nullable = False
        if nulls.any():
            validity = jnp.asarray(~nulls)[idx]
            nullable = True
        return Column(data, validity, STRING.with_nullable(nullable),
                      new_dict)

    def _cast_as_json(self, call: Call) -> Column:
        """CAST(x AS JSON) -> JSON text (reference CastXAsJson sigs):
        numbers keep their decimal text, BOOL comparisons become
        true/false, temporal values become quoted strings, strings
        parse as documents (invalid text becomes a quoted JSON string),
        JSON columns normalize (cast_as_json.test)."""
        import json as _json

        from .regexp_json import json_dumps_mysql

        src = self.evaluate(call.args[0])
        sdt = src.dtype
        if sdt.is_string:
            from .functions import _map_string_to_string

            if sdt.mysql_blob:
                import base64 as _b64

                def jf(s, _c=sdt.mysql_blob):
                    # binary families are JSON OPAQUES:
                    # "base64:type<code>:<b64(bytes)>"
                    b = _b64.b64encode(
                        s.encode("utf-8", "surrogateescape")).decode()
                    return _json.dumps(f"base64:type{_c}:{b}")
            else:
                def jf(s, _isjson=sdt.mysql_json):
                    from ..runtime.errors import EvalError as _EE

                    try:
                        doc = _json.loads(s)
                    except Exception:
                        if _isjson:
                            return s
                        # the reference REJECTS non-JSON text at cast
                        # time per row (TiDB/Decode/JsonBinary.cpp parse
                        # error; cast_as_json.test flag=1/2 rows)
                        return _EE("Invalid JSON text: The document "
                                   "root must not be followed by other "
                                   "values.")
                    if _doc_depth(doc) > 100:
                        # MySQL caps JSON nesting at 100
                        # (cast_as_json.test test_long_str)
                        return _EE("Invalid JSON text: The JSON "
                                   "document exceeds the maximum "
                                   "depth.")
                    return json_dumps_mysql(doc)
            out = _map_string_to_string(src, jf,
                                        errors=self.runtime_errors)
            return Column(out.data, out.validity,
                          dataclasses.replace(out.dtype,
                                              mysql_json=True),
                          out.dictionary)

        def render(v):
            if sdt.kind is TypeKind.BOOL or isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, datetime.datetime):
                # JSON datetimes always carry the 6-digit fraction
                return _json.dumps(
                    f"{v.year:04d}-{v.month:02d}-{v.day:02d} "
                    f"{v.hour:02d}:{v.minute:02d}:{v.second:02d}"
                    f".{v.microsecond:06d}")
            if sdt.kind is TypeKind.DURATION:
                us = int(v)
                sign = "-" if us < 0 else ""
                us = abs(us)
                h, rem = divmod(us // 1_000_000, 3600)
                mi, s2 = divmod(rem, 60)
                return _json.dumps(
                    f"{sign}{h:02d}:{mi:02d}:{s2:02d}"
                    f".{us % 1_000_000:06d}")
            if isinstance(v, datetime.date):
                return _json.dumps(_mysql_value_text(v))
            if isinstance(v, float):
                return _json.dumps(v)  # JSON float text keeps '.0'
            return _mysql_value_text(v)

        out = self._cast_to_string_lut(src, STRING, render=render)
        return Column(out.data, out.validity,
                      dataclasses.replace(out.dtype, mysql_json=True),
                      out.dictionary)

    def _json_build(self, call: Call) -> Column:
        """JSON_ARRAY / JSON_OBJECT (reference json_array/json_object
        sigs): literal args fold; column args (any number, any
        host-enumerable type) compose through the k-ary cross-domain
        LUT — one python build per domain COMBINATION.  String values
        quote, ints/floats/bools inline, JSON columns embed as
        documents, SQL NULL value -> JSON null element.  A NULL KEY is
        a per-row runtime error (json_object.test id=4; TiDB error
        3158)."""
        import json as _json

        from .regexp_json import json_dumps_mysql

        args = call.args
        col_idx = [i for i, a in enumerate(args)
                   if not isinstance(a, Literal)]
        is_obj = call.func == "json_object"

        def build(values):
            if not is_obj:
                return json_dumps_mysql(list(values))
            if len(values) % 2:
                raise ValueError("JSON_OBJECT needs key/value pairs")
            doc = {}
            for i in range(0, len(values), 2):
                k = values[i]
                if k is None:
                    return EvalError("JSON documents may not contain "
                                     "NULL member names.")
                doc[str(k)] = values[i + 1]
            return json_dumps_mysql(doc)

        if not col_idx:
            v = build([a.value for a in args])
            if isinstance(v, EvalError):
                # constant-foldable error: no rows needed to decide
                raise EngineError(v.message)
            return self._encode_string_literal(v, None)

        # JSON-typed column args embed as DOCUMENTS, not quoted text
        json_arg = {i: bool(self.evaluate(args[i]).dtype.mysql_json)
                    for i in col_idx}

        def fn(*vs):
            vals = list(vs)
            for i in col_idx:
                v = vals[i]
                if json_arg[i] and isinstance(v, str):
                    try:
                        vals[i] = _json.loads(v)
                    except Exception:
                        pass
            return build(vals)

        return self._cross_lut(args, fn, name=call.func)

    def _like(self, call: Call, ci: bool = False) -> Column:
        """LIKE/ILIKE pattern matching via host-side dictionary LUT.
        Optional third arg = escape character (reference like3Args /
        ilike3Args sigs, ``Functions/FunctionsStringSearch.h``)."""
        target = self.evaluate(call.args[0])
        pat_expr = call.args[1]
        escape = "\\"
        if len(call.args) > 2:
            esc_expr = call.args[2]
            assert isinstance(esc_expr, Literal), "LIKE escape must be a literal"
            v = esc_expr.value
            escape = chr(int(v)) if isinstance(v, int) else str(v)
        # TiDB ILIKE folds ASCII case ONLY ('ü' does not match 'Ü' —
        # fullstack ilike_pushdown.test), so fold both sides explicitly
        # instead of re.I (unicode-aware)
        fold = _ascii_lower if ci else (lambda s: s)
        if not isinstance(pat_expr, Literal):
            # column pattern: cross-domain LUT over subject x pattern
            # dictionaries (reference like with non-constant pattern
            # matches per row; here one host match per combo)
            def like_fn(s, p):
                if s is None or p is None:
                    return None
                rx = re.compile(_like_to_regex(fold(str(p)), escape), re.S)
                return rx.fullmatch(fold(str(s))) is not None

            from ..core.dtypes import BOOL as _BOOL

            return self._cross_lut_value(call.args[:2], like_fn,
                                         name="like", out_dtype=_BOOL)
        pattern = pat_expr.value
        d = target.dictionary or ()
        regex = re.compile(_like_to_regex(fold(pattern), escape), re.S)
        lut = np.array([regex.fullmatch(fold(s)) is not None for s in d],
                       dtype=bool)
        if len(lut) == 0:
            lut = np.zeros(1, dtype=bool)
        data = jnp.asarray(lut)[jnp.clip(target.data, 0, len(lut) - 1)]
        return Column(data, target.validity, DataType(TypeKind.BOOL, target.dtype.nullable))


def _mysql_substring(s: str, pos: int, length: Optional[int] = None) -> str:
    """1-based; negative pos counts from the end; pos==0 -> empty."""
    if pos == 0:
        return ""
    if pos > 0:
        start = pos - 1
    else:
        start = len(s) + pos
        if start < 0:
            return ""
    piece = s[start:]
    if length is not None:
        if length <= 0:
            return ""
        piece = piece[:length]
    return piece


_STRING_TRANSFORMS = {
    # fn(dict_entry, *literal_args) -> str  (reference FunctionsString.h —
    # here a host LUT over the dictionary, device side is one gather)
    "concat": lambda s, *args: "".join([s] + [str(a) for a in args]),
    "concat_prefix": lambda s, prefix: str(prefix) + s,
    "substring": _mysql_substring,
    "left": lambda s, n: s[: max(int(n), 0)],
    "right": lambda s, n: s[-int(n):] if int(n) > 0 else "",
    # lpad/rpad are handled by the k-ary cross-domain LUT in _call
    # (full MySQL NULL semantics: negative length / empty pad -> NULL)
    "replace": lambda s, old, new: s.replace(str(old), str(new)),
    "repeat": lambda s, n: s * max(int(n), 0),
    "insert_str": lambda s, pos, ln, new: (
        s if int(pos) < 1 or int(pos) > len(s)
        else s[: int(pos) - 1] + str(new) + s[int(pos) - 1 + max(int(ln), 0):]
    ),
    "substring_index": lambda s, delim, n: (
        str(delim).join(s.split(str(delim))[: int(n)]) if int(n) > 0
        else (str(delim).join(s.split(str(delim))[int(n):]) if int(n) < 0 else "")
    ),
}

from . import regexp_json as _rj  # noqa: E402

_STRING_TRANSFORMS.update({
    # regexp family (FunctionsRegexpLike.h / FunctionsRegexpReplace.h)
    "regexp_substr": _rj.regexp_substr,
    "regexp_replace": _rj.regexp_replace,
    # JSON subset (FunctionsJson.h)
    "json_extract": _rj.json_extract,
    "json_unquote": _rj.json_unquote,
    "json_type": _rj.json_type,
    # codecs / misc (FunctionsString.h breadth)
    "to_base64": _rj.to_base64,
    "from_base64": _rj.from_base64,
    "unhex": _rj.unhex,
    "quote": _rj.quote,
    "soundex": _rj.soundex,
    "conv": _rj.conv,
    "sha2": _rj.sha2,
    "json_quote": _rj.json_quote,
    "json_keys": _rj.json_keys,
    # inet6 family over the hex-string VARBINARY stand-in
    # (reference tiDBIPv6StringToNum / tiDBIPv6NumToString sigs)
    "inet6_aton": _rj.inet6_aton,
    "inet6_ntoa": _rj.inet6_ntoa,
})

from .functions import dayname_of_string, monthname_of_string  # noqa: E402

_STRING_TRANSFORMS.update({
    # weekday/month names straight from TEXT: partial-zero and year-0
    # dates are storable values no DATE cast can carry
    # (datename_monthname.test)
    "dayname": dayname_of_string,
    "day_name": dayname_of_string,
    "monthname": monthname_of_string,
    "month_name": monthname_of_string,
})

# functions that return 0/false (never NULL) for NULL input — MySQL
# IS_IPV4/IS_IPV6 family semantics
_NEVER_NULL_FNS = {"is_ipv4", "is_ipv6", "is_ipv4_compat", "is_ipv4_mapped"}

_STRING_INT_TRANSFORMS = {
    # name: (column-arg index, fn(dict_entry, *literal_args) -> int);
    # MySQL 1-based positions, 0 = not found
    "instr": (0, lambda s, needle: s.find(str(needle)) + 1),
    "locate": (1, lambda s, needle: s.find(str(needle)) + 1),
    "position": (1, lambda s, needle: s.find(str(needle)) + 1),
    "strcmp": (0, lambda s, other: (s > str(other)) - (s < str(other))),
    "find_in_set": (0, lambda s, lst: (
        str(lst).split(",").index(s) + 1 if s in str(lst).split(",") else 0)),
    "field": (0, lambda s, *vals: (
        [str(v) for v in vals].index(s) + 1 if s in [str(v) for v in vals] else 0)),
    "regexp_instr": (0, _rj.regexp_instr),
    "json_length": (0, _rj.json_length),
    "json_depth": (0, _rj.json_depth),
    "inet_aton": (0, _rj.inet_aton),
}

_STRING_BOOL_TRANSFORMS = {
    # name: (column-arg index, fn(dict_entry, *literal_args) -> bool|None)
    "regexp_like": (0, _rj.regexp_like),
    "json_valid": (0, _rj.json_valid),
    "json_contains_path": (0, _rj.json_contains_path),
    "json_contains": (0, _rj.json_contains),
    "is_ipv4": (0, _rj.is_ipv4),  # NULL input -> 0, see _NEVER_NULL_FNS
    "is_ipv6": (0, _rj.is_ipv6),
}

_STRING_DATE_TRANSFORMS = {
    # name: fn(dict_entry, *literal_args) -> datetime.date | None
    "str_to_date": _rj.str_to_date,
}


def _mysql_value_text(v) -> str:
    """MySQL CAST(x AS CHAR) text rendering of a host value."""
    import decimal as _dec

    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return str(int(v)) if v == int(v) and abs(v) < 1e16 else repr(v)
    if isinstance(v, _dec.Decimal):
        return str(v)
    if isinstance(v, datetime.datetime):
        s = v.strftime("%Y-%m-%d %H:%M:%S")
        if v.microsecond:
            s += (".%06d" % v.microsecond).rstrip("0")
        return s
    if isinstance(v, datetime.date):
        return v.isoformat()
    return str(v)


def _mysql_int_coerce(v) -> int:
    """MySQL string->int coercion: longest numeric prefix, rounded half
    away from zero; non-numeric -> 0."""
    if isinstance(v, str):
        m = re.match(r"^\s*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?", v)
        f = float(m.group(0)) if m else 0.0
        return int(f + 0.5) if f >= 0 else -int(-f + 0.5)
    return int(v)


def _mysql_format_number(v, d: int = 0) -> str:
    import decimal as _dec

    d = max(int(d), 0)
    if isinstance(v, _dec.Decimal):
        # exact: quantize half-up at d digits (FORMAT(999.9999, 10)
        # must keep the fraction, not collapse through float)
        q = v.quantize(_dec.Decimal(1).scaleb(-d),
                       rounding=_dec.ROUND_HALF_UP,
                       context=_dec.Context(prec=90))
        return f"{q:,.{d}f}"
    return f"{v:,.{d}f}"


def _mysql_make_set(bits: int, *strs) -> str:
    u = bits if bits >= 0 else bits + (1 << 64)
    return ",".join(str(s) for i, s in enumerate(strs) if u & (1 << i))


def _mysql_export_set(bits: int, on, off, sep=",", n=64) -> str:
    u = bits if bits >= 0 else bits + (1 << 64)
    return str(sep).join(
        str(on) if u & (1 << i) else str(off) for i in range(int(n))
    )


_INT_STRING_FNS = {
    # MySQL integer->string functions; negatives print as unsigned
    # 64-bit (two's complement), like the reference
    "bin": lambda v: format(v if v >= 0 else v + (1 << 64), "b"),
    "oct": lambda v: format(v if v >= 0 else v + (1 << 64), "o"),
    "hex": lambda v: format(v if v >= 0 else v + (1 << 64), "X"),
    "format": _mysql_format_number,
    "make_set": _mysql_make_set,
    "export_set": _mysql_export_set,
    # beyond max_allowed_packet (16MB default) MySQL returns NULL
    "space": lambda v: None if v > 16777216 else " " * max(int(v), 0),
    "char": _rj.mysql_char,
    "inet_ntoa": _rj.inet_ntoa,
    "unhex": _rj.unhex,
}


_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")


def _ascii_lower(s: str) -> str:
    """ASCII-only case folding (TiDB ILIKE collation behavior)."""
    return s.translate(_ASCII_LOWER)


def _like_to_regex(pattern: str, escape: str = "\\") -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def evaluate_expr(expr: Expr, block: Block) -> Column:
    return ExprEvaluator(block).evaluate(expr)


__all__ = ["evaluate_expr", "ExprEvaluator", "infer_literal_dtype"]
