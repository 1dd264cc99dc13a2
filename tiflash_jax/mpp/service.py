"""Query service: the RPC surface of the engine.

Role analog: L9 of the reference — ``FlashService`` gRPC endpoints
(``Flash/FlashService.h:51``: Coprocessor, DispatchMPPTask, ...) plus the
HTTP status/metrics servers (``Server/MetricsPrometheus.cpp``,
``docs/tiflash_http_api.md``).  gRPC+protobuf buys the reference nothing
we need here (plans arrive as JSON — plan/serde.py is the tipb analog),
so the surface is a small threaded HTTP server:

  POST /query    {"plan": <plan json>, "distributed": bool, "async": bool}
                 -> {"columns": {name: [values...]}, "summary": {...}}
                 (async: -> {"query_id": N} immediately; poll /result)
  GET  /result?id=N -> state (+ columns/summary when FINISHED)
  POST /cancel   {"query_id": N} -> cooperative abort (the
                 ``FlashService::CancelMPPTask`` analog: frees the
                 admission slot at the next executor checkpoint)
  GET  /metrics  -> flat counter dump (Prometheus-ish, JSON)
  GET  /status   -> tables, devices, backend
  POST /failpoint {"name": ..., "action": "enable"|"disable"|"pause",
                   "probability": p}

Admission control: a bounded semaphore caps concurrent queries (the
MinTSO-scheduler slot analog — deadlock-freedom is trivial here because
queries never wait on each other's exchanges; they are single programs).
The admission wait itself polls the query's cancel flag, so a QUEUED
query can be cancelled before it ever takes a slot.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..plan.serde import plan_from_json
from ..runtime.executor import QueryRunner
from ..runtime.failpoint import FailPoint, FailPointError
from ..runtime.metrics import METRICS
from ..runtime.settings import Settings
from ..storage.catalog import Catalog


class QueryService:
    def __init__(
        self,
        catalog: Catalog,
        mesh=None,
        settings: Optional[Settings] = None,
        max_concurrency: Optional[int] = None,
    ):
        self.catalog = catalog
        self.mesh = mesh
        self.settings = settings or Settings()
        self._admission = threading.BoundedSemaphore(
            max_concurrency or self.settings.service_max_concurrency)
        self._blocks = None
        self._lock = threading.Lock()
        # query registry: the MPPTaskManager / process-list analog
        self._qid = 0
        self._queries: Dict[int, Dict] = {}
        # per-query cancel flags + async results, keyed by query id
        self._cancels: Dict[int, "object"] = {}
        self._results: Dict[int, Dict] = {}

    def _tables(self):
        with self._lock:
            if self._blocks is None:
                blocks = self.catalog.blocks()
                if self.mesh is not None:
                    from .runner import shard_catalog_blocks

                    blocks = shard_catalog_blocks(blocks, self.mesh)
                self._blocks = blocks
            return self._blocks

    def _register(self) -> int:
        from ..runtime.cancel import CancelFlag

        with self._lock:
            self._qid += 1
            qid = self._qid
            self._queries[qid] = {"id": qid, "state": "QUEUED"}
            self._cancels[qid] = CancelFlag()
        return qid

    def cancel(self, qid: int) -> Dict:
        """FlashService::CancelMPPTask analog: cooperative abort."""
        with self._lock:
            flag = self._cancels.get(qid)
            entry = self._queries.get(qid)
            if flag is None or entry is None:
                return {"ok": False, "error": f"unknown query id {qid}"}
            terminal = entry["state"] in ("FINISHED", "FAILED", "CANCELLED")
            if not terminal:
                entry["state"] = "CANCELLING"
        flag.set()
        METRICS.counter("queries_cancelled_total").inc()
        return {"ok": True, "state": "CANCELLING" if not terminal
                else entry["state"]}

    def _acquire_admission(self, flag) -> None:
        """Take an admission slot, polling the cancel flag while QUEUED;
        gives up after ``service_queue_timeout_s`` (0 = wait forever),
        the reference's task-queue wait timeout."""
        import time as _t

        from ..runtime.cancel import QueryCancelled, QueryTimeout

        timeout = getattr(self.settings, "service_queue_timeout_s", 0.0)
        t0 = _t.monotonic()
        while not self._admission.acquire(timeout=0.05):
            if flag.is_set():
                raise QueryCancelled("cancelled while queued for admission")
            if timeout and _t.monotonic() - t0 > timeout:
                raise QueryTimeout("queued past service_queue_timeout_s")

    def execute(self, plan_json: Dict, distributed: Optional[bool] = None,
                qid: Optional[int] = None,
                settings_override: Optional[Dict] = None) -> Dict:
        from ..runtime.cancel import QueryCancelled

        plan = plan_from_json(plan_json)
        mesh = self.mesh if (distributed is None or distributed) else None
        # per-request settings (DAGContext applies tipb flags over the
        # session settings per query, Flash/Coprocessor/DAGContext.h:163);
        # ValueError from unknown names surfaces as a 400
        settings = self.settings
        if settings_override:
            settings = settings.with_overrides(settings_override)
        # system tables are injected fresh per query (single-device scans)
        uses_system = "system_" in json.dumps(plan_json)
        if qid is None:
            qid = self._register()
        with self._lock:
            flag = self._cancels[qid]
        from ..runtime.logging import get_logger, query_context

        log = get_logger("tiflash_jax.service")
        from ..runtime.cancel import cancel_scope
        from ..runtime.syncpoint import sync_point

        try:
            sync_point("service.query.queued")
            self._acquire_admission(flag)
            try:
                with query_context(qid), cancel_scope(flag):
                    with self._lock:
                        if self._queries[qid]["state"] == "QUEUED":
                            self._queries[qid]["state"] = "RUNNING"
                    log.info("query %d start", qid)
                    sync_point("service.query.running")
                    flag.check()
                    tables = self._tables()
                    if uses_system:
                        from ..storage.system import system_blocks

                        tables = dict(tables)
                        tables.update(system_blocks(
                            self.catalog, self.settings,
                            self.queries()["queries"]
                        ))
                        mesh = None  # system scans run single-device
                    runner = QueryRunner(plan, mesh=mesh,
                                         settings=settings, cancel=flag)
                    out, summary = runner.run(tables)
            finally:
                self._admission.release()
        except QueryCancelled:
            with self._lock:
                self._queries[qid]["state"] = "CANCELLED"
            log.info("query %d cancelled", qid)
            raise
        except Exception:
            with self._lock:
                self._queries[qid]["state"] = "FAILED"
            raise
        cols = out.to_pylists()
        with self._lock:
            self._queries[qid].update(
                state="FINISHED", rows=summary.result_rows,
                wall_seconds=summary.wall_seconds, retries=summary.retries,
            )
        return {
            "query_id": qid,
            "columns": cols,
            "summary": {
                "rows": summary.result_rows,
                "wall_seconds": summary.wall_seconds,
                "retries": summary.retries,
                "backend": summary.backend,
                "devices": summary.num_devices,
            },
        }

    def execute_async(self, plan_json: Dict,
                      distributed: Optional[bool] = None,
                      settings_override: Optional[Dict] = None) -> Dict:
        """Submit and return the query id immediately; poll result()."""
        if settings_override:  # validate NOW so bad names 400 at submit
            self.settings.with_overrides(settings_override)
        qid = self._register()

        def work():
            try:
                res = self.execute(plan_json, distributed, qid=qid,
                                   settings_override=settings_override)
                with self._lock:
                    self._results[qid] = res
            except Exception as e:
                with self._lock:
                    self._results[qid] = {
                        "query_id": qid,
                        "error": f"{type(e).__name__}: {e}",
                    }

        threading.Thread(target=work, daemon=True).start()
        return {"query_id": qid}

    def result(self, qid: int) -> Dict:
        with self._lock:
            entry = self._queries.get(qid)
            if entry is None:
                return {"error": f"unknown query id {qid}"}
            res = self._results.get(qid)
            out = {"query_id": qid, "state": entry["state"]}
            if res is not None:
                out.update(res)
            return out

    def queries(self) -> Dict:
        with self._lock:
            return {"queries": list(self._queries.values())[-100:]}

    def status(self) -> Dict:
        import jax

        from ..runtime.memory import device_memory_stats

        return {
            "tables": {
                n: {"rows": t.row_count, "columns": list(t.schema)}
                for n, t in self.catalog.tables.items()
            },
            "backend": jax.default_backend(),
            "devices": len(jax.devices()),
            "distributed": self.mesh is not None,
            "memory": device_memory_stats(),
        }


def make_http_server(service: QueryService, port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj):
            body = json.dumps(obj, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, METRICS.dump())
            elif self.path == "/status":
                self._send(200, service.status())
            elif self.path == "/queries":
                self._send(200, service.queries())
            elif self.path.startswith("/logs"):
                # LogSearch analog (Flash/LogSearch.cpp): grep the
                # in-memory ring of recent records
                from urllib.parse import parse_qs, urlparse

                from ..runtime.logging import RING

                q = parse_qs(urlparse(self.path).query)
                try:
                    self._send(200, {"logs": RING.search(
                        pattern=q.get("q", [""])[0],
                        level=q.get("level", [""])[0],
                        limit=int(q.get("limit", ["200"])[0]),
                    )})
                except Exception as e:  # bad regex etc.
                    self._send(400, {"error": str(e)})
            elif self.path.startswith("/result"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    qid = int(q["id"][0])
                except (KeyError, ValueError):
                    self._send(400, {"error": "need ?id=<query_id>"})
                    return
                self._send(200, service.result(qid))
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            from ..runtime.cancel import QueryCancelled

            try:
                if self.path == "/query":
                    if req.get("async"):
                        self._send(200, service.execute_async(
                            req["plan"], req.get("distributed"),
                            settings_override=req.get("settings")))
                    else:
                        self._send(200, service.execute(
                            req["plan"], req.get("distributed"),
                            settings_override=req.get("settings")))
                elif self.path == "/cancel":
                    self._send(200, service.cancel(int(req["query_id"])))
                elif self.path == "/failpoint":
                    action = req.get("action")
                    if action == "enable":
                        FailPoint.enable(req["name"], req.get("probability"))
                    elif action == "pause":
                        FailPoint.enable(req["name"], pause=True)
                    else:
                        FailPoint.disable(req["name"])
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except QueryCancelled as e:
                from ..runtime.errors import error_payload

                self._send(499, {**error_payload(e), "kind": "cancelled"})
            except FailPointError as e:
                from ..runtime.errors import error_payload

                self._send(500, {**error_payload(e), "kind": "failpoint"})
            except (KeyError, ValueError) as e:
                from ..runtime.errors import error_payload

                self._send(400, error_payload(e))
            except Exception as e:  # surface engine errors as 500s
                from ..runtime.errors import error_payload

                self._send(500, error_payload(e))

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_background(service: QueryService, port: int = 0):
    """Start the HTTP server on a daemon thread; returns (server, port)."""
    httpd = make_http_server(service, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, httpd.server_address[1]


__all__ = ["QueryService", "make_http_server", "serve_background"]
