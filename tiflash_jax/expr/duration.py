"""MySQL TIME (Duration) function family.

Role analog: ``dbms/src/Functions/FunctionsDuration.h`` and the
Duration-sig rows of the reference's scalar map
(/root/reference/dbms/src/Flash/Coprocessor/DAGUtils.cpp:92 —
MakeTime, SecToTime, *TimeDiff, AddDatetimeAndDuration, TimeToSec,
CastDurationAs*, Extract*Duration...).

Device representation: a Duration column is int64 signed
microseconds, clamped to MySQL's TIME range ±838:59:59 — one fixed-width
lane, so comparisons/sorts/joins on durations are the plain int64 paths.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.block import Column
from ..core.dtypes import (
    DataType,
    DURATION_MAX_US,
    TypeKind,
)
from .functions import REGISTRY, register, _and_validity

_DAY_US = 86_400_000_000


def _clamp_dur(us):
    return jnp.clip(us, -DURATION_MAX_US, DURATION_MAX_US)


def _dur(nullable: bool) -> DataType:
    return DataType(TypeKind.DURATION, nullable)


@register("maketime")
def _maketime():
    """MAKETIME(h, m, s): m/s out of [0,60) -> NULL; |h| beyond the TIME
    range clamps (MySQL semantics)."""

    def infer(ts):
        return _dur(True)

    def evaluate(cols, out):
        h, m, s = cols
        hv = h.data.astype(jnp.int64)
        mv = m.data.astype(jnp.int64)
        if s.dtype.is_float:
            s_us = (s.data.astype(jnp.float64) * 1e6).astype(jnp.int64)
            s_ok = (s.data >= 0) & (s.data < 60)
        elif s.dtype.is_decimal:
            sc = s.dtype.scale
            if sc <= 6:
                s_us = s.data.astype(jnp.int64) * (10 ** (6 - sc))
            else:
                s_us = s.data.astype(jnp.int64) // (10 ** (sc - 6))
            s_ok = (s.data >= 0) & (s.data < 60 * (10 ** sc))
        else:
            s_us = s.data.astype(jnp.int64) * 1_000_000
            s_ok = (s.data >= 0) & (s.data < 60)
        ok = (mv >= 0) & (mv < 60) & s_ok
        mag = jnp.abs(hv) * 3_600_000_000 + mv * 60_000_000 + s_us
        us = _clamp_dur(jnp.where(hv < 0, -mag, mag))
        v = _and_validity(cols)
        v = ok if v is None else (v & ok)
        return Column(us, v, out)

    return infer, evaluate


@register("sec_to_time")
def _sec_to_time():
    def infer(ts):
        return _dur(ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        if a.dtype.is_float:
            us = (a.data.astype(jnp.float64) * 1e6).astype(jnp.int64)
        elif a.dtype.is_decimal:
            sc = a.dtype.scale
            if sc <= 6:
                us = a.data.astype(jnp.int64) * jnp.int64(10 ** (6 - sc))
            else:
                us = a.data.astype(jnp.int64) // jnp.int64(10 ** (sc - 6))
        else:
            us = a.data.astype(jnp.int64) * 1_000_000
        return Column(_clamp_dur(us), a.validity, out)

    return infer, evaluate


@register("timediff")
def _timediff():
    """TIMEDIFF(a, b): both datetime or both duration -> Duration; MySQL
    returns NULL when the argument kinds differ (reference NullTimeDiff
    sig) — that case is rejected at compile time here instead."""

    def infer(ts):
        a, b = ts
        same = (
            a.kind is b.kind
            or (a.kind in (TypeKind.DATE, TypeKind.DATETIME)
                and b.kind in (TypeKind.DATE, TypeKind.DATETIME))
        )
        if not same:
            raise TypeError(f"timediff argument kinds differ: {a} vs {b}")
        return _dur(a.nullable or b.nullable)

    def evaluate(cols, out):
        a, b = cols

        def to_us(c):
            if c.dtype.kind is TypeKind.DATE:
                return c.data.astype(jnp.int64) * _DAY_US
            return c.data.astype(jnp.int64)

        us = _clamp_dur(to_us(a) - to_us(b))
        return Column(us, _and_validity(cols), out)

    return infer, evaluate


def _register_addsubtime(name: str, sign: int):
    def factory():
        def infer(ts):
            a, b = ts
            if b.kind is not TypeKind.DURATION:
                raise TypeError(f"{name}: second argument must be TIME, got {b}")
            nullable = a.nullable or b.nullable
            if a.kind in (TypeKind.DATE, TypeKind.DATETIME):
                return DataType(TypeKind.DATETIME, nullable)
            if a.kind is TypeKind.DURATION:
                return _dur(nullable)
            raise TypeError(f"{name}: unsupported first argument {a}")

        def evaluate(cols, out):
            a, b = cols
            av = a.data.astype(jnp.int64)
            if a.dtype.kind is TypeKind.DATE:
                av = av * _DAY_US
            res = av + sign * b.data.astype(jnp.int64)
            if out.kind is TypeKind.DURATION:
                res = _clamp_dur(res)
            return Column(res, _and_validity(cols), out)

        return infer, evaluate

    register(name)(factory)


_register_addsubtime("addtime", 1)
_register_addsubtime("subtime", -1)


@register("time")
def _time_fn():
    """TIME(datetime): the time-of-day part as a Duration (>= 0)."""

    def infer(ts):
        return _dur(ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        if a.dtype.kind is TypeKind.DURATION:
            return Column(a.data, a.validity, out)
        us = a.data.astype(jnp.int64)
        if a.dtype.kind is TypeKind.DATE:
            us = us * 0
        else:
            us = us - jnp.floor_divide(us, _DAY_US) * _DAY_US
        return Column(us, a.validity, out)

    return infer, evaluate


@register("to_seconds")
def _to_seconds():
    """TO_SECONDS(date/datetime): seconds since year 0 (MySQL's
    TO_DAYS * 86400 + time-of-day)."""

    def infer(ts):
        return DataType(TypeKind.INT64, ts[0].nullable)

    def evaluate(cols, out):
        (a,) = cols
        if a.dtype.kind is TypeKind.DATE:
            secs = (a.data.astype(jnp.int64) + 719_528) * 86_400
        else:
            us = a.data.astype(jnp.int64)
            days = jnp.floor_divide(us, _DAY_US)
            tod = (us - days * _DAY_US) // 1_000_000
            secs = (days + 719_528) * 86_400 + tod
        return Column(secs, a.validity, out)

    return infer, evaluate


@register("any_value")
def _any_value():
    """ANY_VALUE(x): identity on the row path (the reference's
    *AnyValue sigs are pass-throughs outside aggregation)."""

    def infer(ts):
        return ts[0]

    def evaluate(cols, out):
        return cols[0]

    return infer, evaluate


@register("time_format")
def _time_format_guard():
    # real implementation lives in compile.py (needs literal format +
    # string dictionary construction); registered here only so the name
    # resolves in coverage checks.
    def infer(ts):
        raise NotImplementedError("time_format is compiled in compile.py")

    def evaluate(cols, out):
        raise NotImplementedError

    return infer, evaluate


def duration_components(us):
    """(sign, h, m, s, frac_us) — components are non-negative (MySQL
    HOUR('-10:10:10') = 10)."""
    neg = us < 0
    mag = jnp.abs(us)
    h = mag // 3_600_000_000
    m = (mag // 60_000_000) % 60
    s = (mag // 1_000_000) % 60
    f = mag % 1_000_000
    return neg, h, m, s, f


__all__ = ["duration_components"]
