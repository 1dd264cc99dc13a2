"""Failpoint framework for fault-injection tests.

Role analog: ``Common/FailPoint.cpp:29-213`` (182 registered failpoints,
``FAIL_POINT_TRIGGER_EXCEPTION``) driving the reference's fault-inject
fullstack tests.  Device code can't throw mid-kernel, so failpoints sit at
host orchestration boundaries (fragment launch, exchange config, retry
loop) — which is also where the reference's MPP failpoints live
(``Flash/executeQuery.cpp:121``).

Supports always-fail and probabilistic (``random_*``) activation.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional


class FailPointError(RuntimeError):
    pass


class FailPoint:
    _registry: Dict[str, "FailPoint"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self.enabled = False
        self.probability: Optional[float] = None
        self.pause = False  # block instead of raise (FAIL_POINT_PAUSE analog)
        self.hits = 0

    @classmethod
    def register(cls, name: str) -> "FailPoint":
        with cls._lock:
            return cls._registry.setdefault(name, cls(name))

    @classmethod
    def get(cls, name: str) -> "FailPoint":
        return cls.register(name)

    @classmethod
    def enable(cls, name: str, probability: Optional[float] = None,
               pause: bool = False):
        fp = cls.register(name)
        fp.enabled = True
        fp.probability = probability
        fp.pause = pause

    @classmethod
    def disable(cls, name: str):
        fp = cls.register(name)
        fp.enabled = False
        fp.probability = None
        fp.pause = False

    @classmethod
    def disable_all(cls):
        for fp in cls._registry.values():
            fp.enabled = False
            fp.probability = None
            fp.pause = False


def fail_point(name: str):
    """Trigger point: raises FailPointError when the named point is armed
    (maybe probabilistically).  A ``pause`` failpoint blocks instead
    (``FAIL_POINT_PAUSE``, ``Common/FailPoint.cpp``) until disabled — or
    until the executing query is cancelled, which raises QueryCancelled
    (the reference unblocks paused tasks on abort the same way)."""
    fp = FailPoint.register(name)
    if not fp.enabled:
        return
    if fp.probability is not None and random.random() >= fp.probability:
        return
    fp.hits += 1
    if fp.pause:
        import time

        from .cancel import checkpoint

        while fp.enabled and fp.pause:
            checkpoint()  # QueryCancelled breaks the pause
            time.sleep(0.01)
        return
    raise FailPointError(
        f"Fail point FailPoints::{name} is triggered")


# the set exercised by tests (extend freely)
for _n in (
    "exception_before_fragment_run",
    "exception_after_fragment_run",
    "exception_before_exchange",
    "exception_during_retry",
    "random_fragment_failure",
    # simulates a backend compile failure on the bucketed final-merge
    # program (runtime/outofcore.py fallback ladder)
    "compile_failure_in_final_merge",
):
    FailPoint.register(_n)


__all__ = ["FailPoint", "fail_point", "FailPointError"]
