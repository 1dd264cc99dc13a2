"""Resource control (token bucket) + TOML settings tests."""

import time

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.runtime.resource import RESOURCE_GROUPS, TokenBucket, to_ru
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.testing import oracle as O


def test_token_bucket_refill_and_limit():
    b = TokenBucket(fill_rate=1000.0, capacity=100.0, tokens=100.0)
    assert b.try_consume(60)
    assert b.try_consume(40)
    assert not b.try_consume(50)  # empty now
    time.sleep(0.06)
    assert b.try_consume(50)  # refilled ~60


def test_resource_group_rejects_when_exhausted():
    RESOURCE_GROUPS.configure("tiny", fill_rate=0.001, capacity=0.001)
    t = {"k": list(range(200_000))}
    blocks = {"t": O.pytable_to_block(t, {"k": dt.INT64})}
    with pytest.raises(RuntimeError, match="resource group"):
        run_query(
            P.TableScan("t"), blocks,
            settings=Settings(resource_group="tiny"),
        )
    # unconfigured group admits freely
    out, _ = run_query(
        P.TableScan("t"), blocks, settings=Settings(resource_group="other")
    )
    assert out.capacity == 200_000


def test_to_ru_scales():
    assert to_ru(1_000_000, 0.0) == pytest.approx(10.0)
    assert to_ru(0, 0.1) == pytest.approx(10.0)


def test_settings_from_toml(tmp_path):
    p = tmp_path / "engine.toml"
    p.write_text(
        """
[engine]
default_shuffle_factor = 3.5
max_capacity_retries = 7
resource_group = "batch"
"""
    )
    s = Settings.from_toml(str(p))
    assert s.default_shuffle_factor == 3.5
    assert s.max_capacity_retries == 7
    assert s.resource_group == "batch"


def test_settings_env_override(monkeypatch):
    monkeypatch.setenv("TIFLASH_JAX_MAX_CAPACITY_RETRIES", "9")
    monkeypatch.setenv("TIFLASH_JAX_TOPN_FAST_PATH", "false")
    s = Settings.from_env()
    assert s.max_capacity_retries == 9
    assert s.topn_fast_path is False


def test_memory_limit_enforced():
    from tiflash_jax.runtime.memory import MemoryLimitError

    t = {"k": list(range(10_000))}
    blocks = {"t": O.pytable_to_block(t, {"k": dt.INT64})}
    with pytest.raises(MemoryLimitError, match="exceed limit"):
        run_query(
            P.TableScan("t"), blocks,
            settings=Settings(max_bytes_per_device=1000),
        )
    out, _ = run_query(
        P.TableScan("t"), blocks,
        settings=Settings(max_bytes_per_device=10**9),
    )
    assert out.capacity == 10_000


def test_out_of_core_chunked_aggregation():
    """Memory-quota breach falls back to chunked partial/final execution
    with identical results (the spill analog)."""
    import tiflash_jax.core.dtypes as dtt
    from tiflash_jax.expr.nodes import col
    from tiflash_jax.ops.aggregate import AggDesc

    rng = __import__("numpy").random.default_rng(5)
    n = 50_000
    t = {
        "k": [int(x) for x in rng.integers(0, 20, n)],
        "v": [int(x) for x in rng.integers(-100, 100, n)],
    }
    blocks = {"t": O.pytable_to_block(t, {"k": dtt.INT32, "v": dtt.INT64})}
    plan = P.Aggregation(
        ["k"],
        [AggDesc("sum", "v", "s"), AggDesc("count", None, "c"),
         AggDesc("avg", "v", "a"), AggDesc("min", "v", "mn")],
        P.Selection(col("v") > -90, P.TableScan("t")),
    )
    # generous run for the expected answer
    want_out, _ = run_query(plan, blocks)
    want = O.block_to_pytable(want_out)
    # tight quota forces chunking
    out, summary = run_query(
        plan, blocks, settings=Settings(max_bytes_per_device=300_000)
    )
    assert "chunked" in summary.plan_text
    got = O.block_to_pytable(out)
    O.assert_tables_equal(got, want)


def test_settings_agg_defaults_applied():
    """Session settings become per-aggregate knobs when the plan leaves
    them unset (group_concat_max_len analog)."""
    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.settings import Settings
    from tiflash_jax.testing import oracle as O

    schema = {"k": dt.INT32, "s": dt.STRING, "v": dt.INT64}
    rng = np.random.default_rng(3)
    table = O.random_pytable(rng, 60, schema, null_prob=0.0, int_range=(0, 3))
    block = O.pytable_to_block(table, schema)
    plan = P.Aggregation(
        ["k"],
        [AggDesc("group_concat", "s", "gc"),
         AggDesc("approx_count_distinct", "v", "acd")],
        P.TableScan("t"),
    )
    s = Settings(group_concat_max_items=2, approx_distinct_sketch_k=256)
    runner = QueryRunner(plan, settings=s)
    aggs = {a.name: a for n in [runner.plan] for a in _walk_aggs(runner.plan)}
    assert aggs["gc"].param == 2.0
    assert aggs["acd"].param == 256.0
    out, _ = runner.run({"t": block})
    got = O.block_to_pytable(out)
    # truncation to 2 items applied
    assert all(g is None or g.count(",") <= 1 for g in got["gc"])


def _walk_aggs(node):
    out = []
    if hasattr(node, "aggs"):
        out.extend(node.aggs)
    for c in getattr(node, "children", ()) or ():
        out.extend(_walk_aggs(c))
    return out


def test_settings_skew_knobs_flow_to_plan():
    from tiflash_jax.plan.auto import AutoPlanConfig
    from tiflash_jax.runtime.settings import Settings

    s = Settings(skew_hot_keys=7, skew_sample_per_device=99)
    cfg = AutoPlanConfig.from_settings(s)
    assert cfg.skew_hot_keys == 7 and cfg.skew_sample_per_device == 99


def test_max_execution_time_setting():
    """max_execution_time analog: deadline fires at a cancellation
    checkpoint (here: inside a paused failpoint)."""
    from tiflash_jax.runtime.cancel import QueryTimeout
    from tiflash_jax.runtime.failpoint import FailPoint

    t = {"k": list(range(100))}
    blocks = {"t": O.pytable_to_block(t, {"k": dt.INT64})}
    FailPoint.enable("exception_before_fragment_run", pause=True)
    try:
        t0 = time.time()
        with pytest.raises(QueryTimeout):
            run_query(P.TableScan("t"), blocks,
                      settings=Settings(max_execution_time_ms=200))
        assert time.time() - t0 < 10
    finally:
        FailPoint.disable_all()
    # without the limit the same plan runs fine
    out, _ = run_query(P.TableScan("t"), blocks, settings=Settings())
    assert out.capacity == 100


def test_query_timestamp_setting():
    """query_timestamp_us pins the query clock for reproducible NOW()."""
    import datetime as pydt

    from tiflash_jax.expr.nodes import call, col

    t = {"k": [1, 2, 3]}
    blocks = {"t": O.pytable_to_block(t, {"k": dt.INT64})}
    us = 1_600_000_000_000_000
    plan = P.Projection({"k": col("k"), "now": call("now")}, P.TableScan("t"))
    out, _ = run_query(plan, blocks,
                       settings=Settings(query_timestamp_us=us))
    vals = O.block_to_pytable(out)["now"]
    assert vals[0] == pydt.datetime(1970, 1, 1) + pydt.timedelta(
        microseconds=us)


def test_enable_spill_off_raises():
    """enable_spill=False turns the out-of-core fallback into a hard
    memory error (the reference's enable_spill switch)."""
    from tiflash_jax.expr.nodes import col
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.runtime.memory import MemoryLimitError

    rng = np.random.default_rng(11)
    t = {"g": [int(x) for x in rng.integers(0, 8, 30_000)],
         "v": [int(x) for x in rng.integers(0, 100, 30_000)]}
    blocks = {"t": O.pytable_to_block(t, {"g": dt.INT64, "v": dt.INT64})}
    plan = P.Aggregation(keys=["g"], aggs=[AggDesc("sum", "v", "s")],
                         child=P.TableScan("t"))
    small = 200_000
    with pytest.raises(MemoryLimitError):
        run_query(plan, blocks, settings=Settings(
            max_bytes_per_device=small, enable_spill=False))
    out, _ = run_query(plan, blocks, settings=Settings(
        max_bytes_per_device=small))  # spill on: succeeds
    got = O.block_to_pytable(out)
    assert sorted(got["g"]) == list(range(8))


def test_service_queue_timeout():
    """service_queue_timeout_s: a QUEUED query gives up its wait."""
    import json as _json
    import threading
    import urllib.request

    from tiflash_jax.bench.tpch_queries import q6_plan
    from tiflash_jax.mpp.service import QueryService, serve_background
    from tiflash_jax.plan import serde
    from tiflash_jax.runtime.failpoint import FailPoint
    from tiflash_jax.storage.tpch import generate_tpch

    cat = generate_tpch(sf=0.001, seed=5)
    svc = QueryService(cat, mesh=None, max_concurrency=1,
                       settings=Settings(service_queue_timeout_s=0.4))
    httpd, port = serve_background(svc)
    url = f"http://127.0.0.1:{port}"

    def post(path, obj):
        req = urllib.request.Request(
            url + path, data=_json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, _json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, _json.loads(e.read())

    plan_json = serde.plan_to_json(q6_plan())
    try:
        post("/failpoint", {"name": "exception_before_fragment_run",
                            "action": "pause"})
        _, sub1 = post("/query", {"plan": plan_json, "async": True})
        t0 = time.time()
        while time.time() - t0 < 20:
            with urllib.request.urlopen(
                    url + f"/result?id={sub1['query_id']}") as r:
                if _json.loads(r.read())["state"] == "RUNNING":
                    break
            time.sleep(0.05)
        # second query queues behind the paused one and times out
        code, res = post("/query", {"plan": plan_json})
        assert "max_execution_time" in str(res) or "timeout" in str(res).lower() \
            or "queue" in str(res).lower(), (code, res)
        post("/cancel", {"query_id": sub1["query_id"]})
    finally:
        FailPoint.disable_all()
        httpd.shutdown()


def test_config_template_loads_and_covers_every_setting():
    """etc/config-template.toml: every uncommented key is a real Settings
    field, and loading it reproduces the defaults."""
    import dataclasses
    import os

    from tiflash_jax.runtime.settings import Settings

    path = os.path.join(os.path.dirname(__file__), "..",
                        "etc", "config-template.toml")
    s = Settings.from_toml(path)
    assert s == Settings()
    import tomllib
    with open(path, "rb") as f:
        keys = set(tomllib.load(f)["engine"].keys())
    fields = {f.name for f in dataclasses.fields(Settings)}
    assert keys <= fields
    # all but the two None-default fields appear
    assert len(keys) >= len(fields) - 2
