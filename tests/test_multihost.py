"""Multi-host MPP validation: two real OS processes, jax.distributed over
Gloo, 2 CPU devices per process (4 global).

Role analog: ``Flash/tests/gtest_compute_server.cpp`` — the reference
tests multi-node MPP without a cluster; here the driver spawns two
worker processes (tests/multihost_worker.py) that each hold only their
half of the data, assemble global tables via ``shard_local_blocks``, run
a distributed aggregation + shuffle join, and must both report the exact
oracle result.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.testing import oracle as O

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(WORKER))
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    # Drain both workers CONCURRENTLY: each RESULT line is larger than a
    # pipe buffer, so a serial communicate() leaves the second worker
    # blocked on a full pipe — it then never reaches the shutdown barrier
    # and the first worker's barrier timeout kills it mid-write.
    with ThreadPoolExecutor(len(procs)) as pool:
        futs = [pool.submit(p.communicate, timeout=360) for p in procs]
        try:
            pairs = [f.result() for f in futs]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    outs = []
    for p, (out, err) in zip(procs, pairs):
        # Key on the RESULT line, not the exit code: post-barrier teardown
        # of the coordination service is racy (a worker that already
        # printed its correct result can be fataled by the peer's exit).
        if "RESULT" not in out:
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    # identical deterministic tables as the worker builds them
    rng = np.random.default_rng(11)
    t = O.random_pytable(rng, 512, {"k": dt.INT32, "v": dt.INT64},
                         int_range=(0, 23))
    r = O.random_pytable(rng, 128, {"rk": dt.INT32, "rv": dt.INT64},
                         int_range=(0, 23))
    want_agg = O.o_aggregate(t, ["k"], [("sum", "v", "s"),
                                        ("count", None, "c")])
    want_join = O.o_join(t, r, ["k"], ["rk"], kind="inner")
    want_ro = O.o_join(t, r, ["k"], ["rk"], kind="right_outer")
    tw = dict(t)
    tw["p2"] = [k % 2 for k in t["k"]]
    from tiflash_jax.ops.window import WindowDesc

    want_win = O.o_window(tw, ["p2"], [("v", False)],
                          [WindowDesc("row_number", "rn"),
                           WindowDesc("rank", "rk2"),
                           WindowDesc("sum", "rs", arg="v")])

    for out in outs:  # every process must see the same, correct result
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert line, f"no RESULT line in worker output:\n{out[-2000:]}"
        got = json.loads(line[-1][len("RESULT"):])
        O.assert_tables_equal(got["agg"], want_agg)
        O.assert_tables_equal(got["join"], want_join)
        O.assert_tables_equal(got["right_outer"], want_ro)
        O.assert_tables_equal(got["window"], want_win)
