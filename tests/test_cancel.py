"""Query cancellation tests.

Role analog: ``Flash/Mpp/MPPTask.h:121-126`` abort paths +
``FlashService::CancelMPPTask`` — a running (failpoint-paused) query is
cancelled over HTTP, frees its admission slot, and a QUEUED query can be
cancelled before it ever takes a slot.
"""

import json
import time
import urllib.request

import pytest

from tiflash_jax.bench.tpch_queries import q6_plan
from tiflash_jax.mpp.service import QueryService, serve_background
from tiflash_jax.plan import serde
from tiflash_jax.runtime.cancel import CancelFlag, QueryCancelled
from tiflash_jax.runtime.executor import QueryRunner
from tiflash_jax.runtime.failpoint import FailPoint
from tiflash_jax.storage.tpch import generate_tpch


@pytest.fixture(scope="module")
def cat():
    return generate_tpch(sf=0.001, seed=5)


@pytest.fixture()
def server(cat):
    svc = QueryService(cat, mesh=None, max_concurrency=1)
    httpd, port = serve_background(svc)
    yield f"http://127.0.0.1:{port}"
    FailPoint.disable_all()
    httpd.shutdown()


def _post(url, path, obj):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path) as r:
        return r.status, json.loads(r.read())


def _wait_state(url, qid, states, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        _, res = _get(url, f"/result?id={qid}")
        if res["state"] in states:
            return res
        time.sleep(0.02)
    raise AssertionError(f"query {qid} never reached {states}: {res}")


def test_cancel_running_query_frees_slot(server):
    plan_json = serde.plan_to_json(q6_plan())
    # stall the query inside the executor (FAIL_POINT_PAUSE analog)
    code, _ = _post(server, "/failpoint",
                    {"name": "exception_before_fragment_run",
                     "action": "pause"})
    assert code == 200
    _, sub = _post(server, "/query", {"plan": plan_json, "async": True})
    qid = sub["query_id"]
    _wait_state(server, qid, ("RUNNING",))
    code, res = _post(server, "/cancel", {"query_id": qid})
    assert code == 200 and res["ok"]
    res = _wait_state(server, qid, ("CANCELLED",))
    assert "error" in res and "cancel" in res["error"].lower()
    # the admission slot is free again: a normal query runs to completion
    _post(server, "/failpoint",
          {"name": "exception_before_fragment_run", "action": "disable"})
    code, res = _post(server, "/query", {"plan": plan_json})
    assert code == 200 and "columns" in res


def test_cancel_queued_query(server):
    plan_json = serde.plan_to_json(q6_plan())
    _post(server, "/failpoint",
          {"name": "exception_before_fragment_run", "action": "pause"})
    _, sub1 = _post(server, "/query", {"plan": plan_json, "async": True})
    _wait_state(server, sub1["query_id"], ("RUNNING",))
    # second query blocks on the (size-1) admission semaphore
    _, sub2 = _post(server, "/query", {"plan": plan_json, "async": True})
    q2 = sub2["query_id"]
    time.sleep(0.2)
    _, res = _get(server, f"/result?id={q2}")
    assert res["state"] == "QUEUED"
    code, res = _post(server, "/cancel", {"query_id": q2})
    assert code == 200 and res["ok"]
    _wait_state(server, q2, ("CANCELLED",))
    # clean up the paused first query
    _post(server, "/cancel", {"query_id": sub1["query_id"]})
    _wait_state(server, sub1["query_id"], ("CANCELLED",))


def test_cancel_unknown_id(server):
    code, res = _post(server, "/cancel", {"query_id": 99999})
    assert code == 200 and not res["ok"]


def test_runner_pre_cancelled(cat):
    flag = CancelFlag()
    flag.set()
    runner = QueryRunner(q6_plan(), cancel=flag)
    with pytest.raises(QueryCancelled):
        runner.run(cat.blocks())


def test_sync_query_cancelled_returns_499(server):
    import threading

    plan_json = serde.plan_to_json(q6_plan())
    _post(server, "/failpoint",
          {"name": "exception_before_fragment_run", "action": "pause"})
    out = {}

    def submit():
        out["resp"] = _post(server, "/query", {"plan": plan_json})

    t = threading.Thread(target=submit)
    t.start()
    # wait until it registers as RUNNING, then cancel via the process list
    t0 = time.time()
    qid = None
    while time.time() - t0 < 30:
        _, qs = _get(server, "/queries")
        running = [q for q in qs["queries"] if q["state"] == "RUNNING"]
        if running:
            qid = running[-1]["id"]
            break
        time.sleep(0.02)
    assert qid is not None
    _post(server, "/cancel", {"query_id": qid})
    t.join(timeout=30)
    assert not t.is_alive()
    code, res = out["resp"]
    assert code == 499 and res["kind"] == "cancelled"
