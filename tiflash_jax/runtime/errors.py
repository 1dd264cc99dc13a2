"""Error-code registry.

Role analog: ``Common/ErrorCodes.cpp`` (the reference numbers every
engine error; clients and logs key off the code, not the message) and
TiFlash's gRPC status mapping.  Codes are stable integers; the service
surfaces them in error payloads and the /metrics counter family
``errors_total{code}`` counts by code.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

# stable numeric registry (never renumber; append only)
OK = 0
UNKNOWN = 1
BAD_PLAN = 10            # malformed / unsupported plan json
UNKNOWN_TABLE = 11
UNKNOWN_COLUMN = 12
TYPE_MISMATCH = 13
UNSUPPORTED = 14         # feature combination not implemented
CAPACITY_OVERFLOW = 20   # bounded-output overflow after max retries
MEMORY_LIMIT = 21
CANCELLED = 30
FAILPOINT = 40
RESOURCE_EXHAUSTED = 41  # RU admission rejected
LIMIT_EXCEEDED = 42      # max_rows_to_* / max_result_rows breached
RUNTIME_EVAL = 43        # per-row evaluation error (invalid JSON, ...)
INTERNAL = 50

_NAMES: Dict[int, str] = {
    OK: "OK",
    UNKNOWN: "UNKNOWN",
    BAD_PLAN: "BAD_PLAN",
    UNKNOWN_TABLE: "UNKNOWN_TABLE",
    UNKNOWN_COLUMN: "UNKNOWN_COLUMN",
    TYPE_MISMATCH: "TYPE_MISMATCH",
    UNSUPPORTED: "UNSUPPORTED",
    CAPACITY_OVERFLOW: "CAPACITY_OVERFLOW",
    MEMORY_LIMIT: "MEMORY_LIMIT",
    CANCELLED: "CANCELLED",
    FAILPOINT: "FAILPOINT",
    RESOURCE_EXHAUSTED: "RESOURCE_EXHAUSTED",
    LIMIT_EXCEEDED: "LIMIT_EXCEEDED",
    RUNTIME_EVAL: "RUNTIME_EVAL",
    INTERNAL: "INTERNAL",
}


def error_name(code: int) -> str:
    return _NAMES.get(code, f"CODE_{code}")


class EngineError(RuntimeError):
    """Base for typed engine errors; carries a stable code."""

    code: int = UNKNOWN

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class EvalError:
    """Sentinel a host LUT function returns for a PER-ROW runtime error
    (the reference throws mid-column-evaluation: CastStringAsJson on
    invalid text, ``TiDB/Decode/JsonBinary.cpp``; JSON_OBJECT with a
    NULL key).  Nothing can throw inside a compiled XLA program, so
    the evaluator turns these into a per-row boolean error lane, the
    fragment compiler reduces live-row lanes to scalar flags returned
    beside the capacity-overflow flags, and the host raises
    ``EngineError`` after execution — the runtime error channel."""

    __slots__ = ("message",)

    def __init__(self, message: str):
        self.message = message


# reserved key prefix carrying runtime-error flags through the
# (block, overflows) fragment return contract
RTERR_PREFIX = "__rterr__"


def split_runtime_errors(flags: Dict) -> tuple:
    """Split a fragment's flag dict into (capacity_overflows,
    {message: scalar_flag}) — the latter is the runtime error channel."""
    cap = {k: v for k, v in flags.items() if not k.startswith(RTERR_PREFIX)}
    err = {k[len(RTERR_PREFIX):]: v for k, v in flags.items()
           if k.startswith(RTERR_PREFIX)}
    return cap, err


def raise_runtime_errors(err_flags: Dict) -> None:
    """Raise EngineError for any set runtime-error flag (host-side,
    post-execution — the analog of the reference's per-row throw)."""
    import numpy as _np

    for msg, v in err_flags.items():
        if bool(_np.asarray(v).max()):
            raise EngineError(msg, RUNTIME_EVAL)


def classify(exc: BaseException) -> int:
    """Map any exception to a registry code (the gRPC-status analog)."""
    from .cancel import QueryCancelled
    from .failpoint import FailPointError
    from .memory import MemoryLimitError

    if isinstance(exc, EngineError):
        return exc.code
    if isinstance(exc, QueryCancelled):
        return CANCELLED
    if isinstance(exc, MemoryLimitError):
        return MEMORY_LIMIT
    if isinstance(exc, FailPointError):
        return FAILPOINT
    if isinstance(exc, KeyError):
        return UNKNOWN_COLUMN
    if isinstance(exc, NotImplementedError):
        return UNSUPPORTED
    if isinstance(exc, (TypeError, ValueError)):
        return BAD_PLAN
    msg = str(exc)
    if "capacity" in msg and "overflow" in msg:
        return CAPACITY_OVERFLOW
    if "resource group" in msg:
        return RESOURCE_EXHAUSTED
    return INTERNAL


def error_payload(exc: BaseException) -> Dict:
    """JSON error body for the service: message + stable code + name."""
    code = classify(exc)
    from .metrics import METRICS

    METRICS.counter(f"errors_total_code_{code}").inc()
    return {
        "error": f"{type(exc).__name__}: {exc}",
        "code": code,
        "code_name": error_name(code),
    }


__all__ = ["EngineError", "EvalError", "classify", "error_payload",
           "error_name", "split_runtime_errors", "raise_runtime_errors",
           "RTERR_PREFIX"]
