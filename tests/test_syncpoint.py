"""Deterministic-interleaving concurrency tests via sync points.

Role analog: ``Common/SyncPoint/SyncPoint.h`` + its gtest usage — the
reference pauses a worker AT a named point, interleaves control actions,
then releases; no sleeps, no stochastic schedules.  These tests pin the
exact interleavings the stochastic service tests only sample:
cancel-while-running, cancel-while-queued, and admission-queue ordering.
"""

import threading
import time

import pytest

from tiflash_jax.bench.tpch_queries import q1_plan
from tiflash_jax.mpp.service import QueryService
from tiflash_jax.plan import serde
from tiflash_jax.runtime.syncpoint import SyncPoint, sync_point
from tiflash_jax.storage.tpch import generate_tpch


@pytest.fixture(scope="module")
def cat():
    return generate_tpch(sf=0.001, seed=5)


@pytest.fixture(autouse=True)
def _clean_syncpoints():
    yield
    SyncPoint.disable_all()


def _submit(svc, results, key):
    plan = serde.plan_to_json(q1_plan())

    def work():
        try:
            results[key] = svc.execute(plan)
        except Exception as e:
            results[key] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def test_syncpoint_primitive_park_release():
    hits = []

    def worker():
        hits.append("before")
        sync_point("unit.point")
        hits.append("after")

    with SyncPoint.enable("unit.point") as sp:
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        sp.wait_for_arrival()
        assert hits == ["before"]        # deterministically parked
        sp.release()
        t.join(timeout=10)
        assert hits == ["before", "after"]


def test_syncpoint_disabled_is_noop():
    t0 = time.time()
    sync_point("never.enabled")
    assert time.time() - t0 < 0.5


def test_cancel_while_running_deterministic(cat):
    """Park the query at the RUNNING transition, cancel it, release:
    it MUST finish CANCELLED — the exact interleaving, not a race."""
    svc = QueryService(cat, mesh=None, max_concurrency=2)
    results = {}
    with SyncPoint.enable("service.query.running") as sp:
        t = _submit(svc, results, "q")
        sp.wait_for_arrival()
        qs = svc.queries()["queries"]
        assert qs[-1]["state"] == "RUNNING"
        svc.cancel(qs[-1]["id"])
        sp.release()
        t.join(timeout=60)
    from tiflash_jax.runtime.cancel import QueryCancelled

    assert isinstance(results["q"], QueryCancelled)
    assert svc.queries()["queries"][-1]["state"] == "CANCELLED"


def test_cancel_while_queued_deterministic(cat):
    """With one admission slot held by a parked query, a second query is
    deterministically QUEUED; cancelling it must free it without running."""
    svc = QueryService(cat, mesh=None, max_concurrency=1)
    results = {}
    with SyncPoint.enable("service.query.running") as sp:
        ta = _submit(svc, results, "a")
        sp.wait_for_arrival()          # A holds the only slot, parked
        tb = _submit(svc, results, "b")
        deadline = time.time() + 30    # B must register as QUEUED
        while time.time() < deadline:
            qs = {q["id"]: q["state"] for q in svc.queries()["queries"]}
            if len(qs) == 2 and list(qs.values())[1] == "QUEUED":
                break
            time.sleep(0.01)
        qs = svc.queries()["queries"]
        assert qs[-1]["state"] == "QUEUED"
        svc.cancel(qs[-1]["id"])
        tb.join(timeout=30)
        from tiflash_jax.runtime.cancel import QueryCancelled

        assert isinstance(results["b"], QueryCancelled)
        assert svc.queries()["queries"][-1]["state"] == "CANCELLED"
        sp.release()                   # A proceeds to completion
        ta.join(timeout=120)
    assert not isinstance(results["a"], Exception)
    assert svc.queries()["queries"][0]["state"] == "FINISHED"


def test_admission_fifo_under_park(cat):
    """Two queued queries behind a parked one both complete after release
    (slot is recycled; no slot leak from the parked/cancelled mix)."""
    svc = QueryService(cat, mesh=None, max_concurrency=1)
    results = {}
    with SyncPoint.enable("service.query.running") as sp:
        ta = _submit(svc, results, "a")
        sp.wait_for_arrival()
        tb = _submit(svc, results, "b")
        tc = _submit(svc, results, "c")
        sp.release(3)                  # a continues; b and c won't re-park
        ta.join(timeout=120)
        tb.join(timeout=120)
        tc.join(timeout=120)
    for k in ("a", "b", "c"):
        assert not isinstance(results[k], Exception), results[k]
    states = [q["state"] for q in svc.queries()["queries"]]
    assert states == ["FINISHED"] * 3
