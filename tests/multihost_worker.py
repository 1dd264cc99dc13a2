"""Worker process for the 2-process multi-host test (test_multihost.py).

Runs the SAME SPMD program in every process (the reference's one-TiFlash-
per-node analog, gtest_compute_server.cpp discipline: multi-node MPP
without a cluster): each process holds only its own rows, assembles the
global sharded tables via ``shard_local_blocks``, executes a distributed
aggregation and a shuffle join, and prints the collected results as JSON.

Must be launched with XLA_FLAGS=--xla_force_host_platform_device_count=2
for two CPU devices per process.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]

    from tiflash_jax.mpp.multihost import (
        global_mesh,
        init_multihost,
        replicate_result,
        shard_local_blocks,
    )

    init_multihost(coordinator=f"127.0.0.1:{port}", num_processes=2,
                   process_id=pid)
    assert jax.process_count() == 2

    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.mpp.runner import collect_result, compile_distributed
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.distribute import shuffle_join, split_aggregation
    from tiflash_jax.testing import oracle as O

    # deterministic full tables; THIS process materializes only its half
    rng = np.random.default_rng(11)
    n, nr = 512, 128
    tschema = {"k": dt.INT32, "v": dt.INT64}
    rschema = {"rk": dt.INT32, "rv": dt.INT64}
    t_full = O.random_pytable(rng, n, tschema, int_range=(0, 23))
    r_full = O.random_pytable(rng, nr, rschema, int_range=(0, 23))
    half = slice(pid * n // 2, (pid + 1) * n // 2)
    rhalf = slice(pid * nr // 2, (pid + 1) * nr // 2)
    t_loc = {c: t_full[c][half] for c in t_full}
    r_loc = {c: r_full[c][rhalf] for c in r_full}

    mesh = global_mesh()
    blocks = shard_local_blocks(
        {
            "t": O.pytable_to_block(t_loc, tschema),
            "r": O.pytable_to_block(r_loc, rschema),
        },
        mesh,
    )

    results = {}

    agg_plan = split_aggregation(
        ["k"], [AggDesc("sum", "v", "s"), AggDesc("count", None, "c")],
        P.TableScan("t"),
    )
    out, overflows = compile_distributed(agg_plan, mesh)(blocks)
    assert all(not bool(np.asarray(v).max()) for v in overflows.values())
    results["agg"] = O.block_to_pytable(
        collect_result(replicate_result(out, mesh)))

    join_plan = shuffle_join(
        kind="inner", probe_keys=["k"], build_keys=["rk"],
        probe=P.TableScan("t"), build=P.TableScan("r"),
        output_capacity=8192,
    )
    out, overflows = compile_distributed(join_plan, mesh)(blocks)
    assert all(not bool(np.asarray(v).max()) for v in overflows.values())
    results["join"] = O.block_to_pytable(
        collect_result(replicate_result(out, mesh)))

    # right-outer across processes: the matched-flag OR must compose
    # over the real multi-process collectives
    ro_plan = shuffle_join(
        kind="right_outer", probe_keys=["k"], build_keys=["rk"],
        probe=P.TableScan("t"), build=P.TableScan("r"),
        output_capacity=8192,
    )
    out, overflows = compile_distributed(ro_plan, mesh)(blocks)
    assert all(not bool(np.asarray(v).max()) for v in overflows.values())
    results["right_outer"] = O.block_to_pytable(
        collect_result(replicate_result(out, mesh)))
    print("RO-DONE", file=sys.stderr, flush=True)

    # laned window (2 partitions over 4 global devices): lane stitching
    # carries psum across PROCESSES
    from tiflash_jax.ops.sort import SortKey
    from tiflash_jax.ops.window import WindowDesc
    from tiflash_jax.plan.auto import distribute_plan

    # window over the full (host-replicated) table for planning stats
    t_full_blk = O.pytable_to_block(t_full, tschema)
    wplan = P.Window(["p2"], [SortKey("v")],
                     [WindowDesc("row_number", "rn"),
                      WindowDesc("rank", "rk2"),
                      WindowDesc("sum", "rs", arg="v")],
                     P.TableScan("tw"))
    tw_full = dict(t_full)
    tw_full["p2"] = [k % 2 for k in t_full["k"]]
    tw_schema = dict(tschema, p2=dt.INT32)
    tw_loc = {c: tw_full[c][half] for c in tw_full}
    wblocks = shard_local_blocks(
        {"tw": O.pytable_to_block(tw_loc, tw_schema)}, mesh)
    print("WIN-PLAN", file=sys.stderr, flush=True)
    dplan = distribute_plan(
        wplan, {"tw": n}, jax.device_count(),
        tables={"tw": O.pytable_to_block(tw_full, tw_schema)})
    assert "LanedWindow" in dplan.pretty(), dplan.pretty()
    from tiflash_jax.mpp.runner import ExchangeConfig

    print("WIN-COMPILE", file=sys.stderr, flush=True)
    out, overflows = compile_distributed(
        dplan, mesh, cfg=ExchangeConfig(shuffle_factor=8.0))(wblocks)
    print("WIN-RAN", file=sys.stderr, flush=True)
    assert all(not bool(np.asarray(v).max()) for v in overflows.values())
    print("WIN-OV", file=sys.stderr, flush=True)
    rep = replicate_result(out, mesh)
    print("WIN-REPL", file=sys.stderr, flush=True)
    results["window"] = O.block_to_pytable(collect_result(rep))
    print("WIN-COLLECT", file=sys.stderr, flush=True)

    print("RESULT" + json.dumps(results), flush=True)

    # Explicit shutdown is a cross-process barrier: both workers reach it
    # after printing RESULT, so neither kills the coordination service
    # while the other still needs it. The atexit teardown that would run
    # otherwise has been observed to wedge for minutes under load, so
    # after the barrier exit hard — the result is already on stdout.
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        jax.distributed.shutdown()
    except Exception:
        pass
    os._exit(0)


if __name__ == "__main__":
    main()
