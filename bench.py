"""Benchmark: prints one JSON record per run.

    python bench.py [--config all|q1|q3|q6|topn|topn100m] [--sf 1]

Configs (BASELINE.md), each in its own subprocess, one at a time, so that
only one process ever holds the card (the parent never starts JAX):

- q1, q6: TPC-H Q1 and Q6 at ``--sf`` on one card.  ``vs_baseline`` is the
  roofline floor, the bytes of the columns the query reads over the
  device's peak memory bandwidth (``PEAK_HBM_BYTES_PER_S``), divided by
  the measured time: 1.0 is the memory-bound speed of light.
- q3, topn: TPC-H Q3, and ORDER BY l_extendedprice DESC LIMIT 100, at
  ``--sf``; topn100m: the same top-N over 100M synthetic int64 keys.  They
  report no ``vs_baseline`` until a floor measured on the card exists.

Timing inside a child: every iteration's input is perturbed by a carry
computed from the previous iteration's checksum of every output value, so
K iterations form one serial dependency chain on the device, run inside
one jit via ``lax.fori_loop``; two chain lengths are differenced to cancel
the fixed dispatch and fetch cost: t_iter = (t(K2) - t(K1)) / (K2 - K1).

Every record names the device it ran on (platform, device kind, device
count, and the ``nvidia-smi`` name and power limit).  A child that finds no
GPU fails, and a failed or timed-out child makes the run exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# columns each config actually reads (for the roofline denominator)
COLS_READ = {
    "q1": ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate"],
    "q3": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"],
    "q6": ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"],
    "topn": ["l_orderkey", "l_extendedprice"],
}

# peak device-memory bandwidth by JAX device_kind, bytes/s (NVIDIA's data
# sheet: H100 SXM, 80 GB HBM3 at 3.35 TB/s)
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

ALL_CONFIGS = ["q1", "q3", "q6", "topn", "topn100m"]


def peak_hbm_bandwidth(device_kind: str) -> float:
    """The data-sheet memory bandwidth of ``device_kind``; a device that is
    not in the table is an error, not a default."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(f"no peak memory bandwidth known for device kind "
                       f"{device_kind!r}; add it to PEAK_HBM_BYTES_PER_S"
                       ) from None


def device_record() -> dict:
    import jax

    from tiflash_jax.runtime.device import card_line

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card_line()}


def chain_seconds(step, args, k1: int, k2: int, vlog, tag: str) -> float:
    """Per-iteration seconds of ``step(args, carry) -> carry`` from two
    differenced ``fori_loop`` chains; each chain gets a fresh carry seed."""
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=2)
    def chain_fn(a, carry, K):
        return jax.lax.fori_loop(0, K, lambda i, c: step(a, c), carry)

    seed = [0]

    def chain(K):
        seed[0] += 1
        t0 = time.perf_counter()
        int(chain_fn(args, jnp.int64(seed[0]), K))  # full sync
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    chain(k1)  # each static K compiles once
    chain(k2)
    vlog(f"[{tag}] compile+first {time.perf_counter() - t0:.1f}s")
    while True:
        t_a = min(chain(k1) for _ in range(2))
        t_b = min(chain(k2) for _ in range(2))
        # the chain-length difference must clear the host's timing noise:
        # sub-ms iterations need longer chains
        if (t_b - t_a) >= 0.030 or k2 >= 512:
            t = max((t_b - t_a) / (k2 - k1), 1e-9)
            vlog(f"[{tag}] t(K1={k1})={t_a * 1e3:.1f}ms "
                 f"t(K2={k2})={t_b * 1e3:.1f}ms -> {t * 1e3:.3f}ms/iter")
            return t
        k1, k2 = k1 * 4, k2 * 4
        vlog(f"[{tag}] slope below the noise floor; K1={k1} K2={k2}")


def bench_config(config: str, cat, args, vlog) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tiflash_jax.bench.tpch_queries import (
        q1_plan, q3_plan, q6_plan, sort_topn_plan)
    from tiflash_jax.plan.auto import autosize_plan
    from tiflash_jax.plan.compiler import execute_plan
    from tiflash_jax.runtime.analyze import block_checksum, perturb_column

    plan = {"q1": q1_plan, "q3": q3_plan,
            "q6": q6_plan, "topn": lambda: sort_topn_plan(100)}[config]()
    blocks = cat.blocks()
    autosize_plan(plan, blocks)  # stats-derived capacities (no hand knobs)
    li = cat["lineitem"].block
    n_rows = cat["lineitem"].row_count
    bytes_read = sum(li[c].data.nbytes for c in COLS_READ[config])
    # perturb a measure column, never a clustering key: flipping key bits
    # would void the block's clustered_by property and change the plan
    perturb = {"q3": "l_extendedprice"}.get(config, COLS_READ[config][0])

    def bench_step(tables, carry):
        tables = dict(tables)
        tables["lineitem"] = tables["lineitem"].with_column(
            perturb, perturb_column(tables["lineitem"][perturb], carry))
        out = execute_plan(plan, tables)
        # a fusion fence between the plan's outputs and the checksum, so
        # the timed program holds the plan's own fusions
        cols = tuple(dataclasses.replace(
            c, data=jax.lax.optimization_barrier(c.data),
            validity=None if c.validity is None
            else jax.lax.optimization_barrier(c.validity))
            for c in out.columns)
        sel = None if out.sel is None else jax.lax.optimization_barrier(out.sel)
        out = dataclasses.replace(out, columns=cols, sel=sel)
        return block_checksum(out) + carry * jnp.int64(0x9E3779B1)

    t_iter = chain_seconds(bench_step, blocks, args.k1, args.k2, vlog, config)
    record = {
        "metric": f"tpch_{config}_sf{args.sf:g}_rows_per_s",
        "value": round(n_rows / t_iter / 1e6, 1),
        "unit": "Mrows/s",
        "t_iter_ms": round(t_iter * 1e3, 3),
        "bytes_read": bytes_read,
    }
    if config in ("q1", "q6"):
        peak = peak_hbm_bandwidth(jax.devices()[0].device_kind)
        record["vs_baseline"] = round(bytes_read / peak / t_iter, 3)
    return record


def bench_topn_100m(args, vlog) -> dict:
    """BASELINE config 3 at its real size: ORDER BY ... LIMIT 100 over a
    100M-row synthetic int64 column."""
    import jax
    import jax.numpy as jnp

    from tiflash_jax.core.block import Block, Column
    from tiflash_jax.core.dtypes import INT64
    from tiflash_jax.ops.sort import SortKey
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.compiler import execute_plan
    from tiflash_jax.runtime.analyze import block_checksum, perturb_column

    N = 100_000_000
    k = (jax.random.bits(jax.random.PRNGKey(1), (N,), dtype=jnp.uint64)
         >> jnp.uint64(1)).astype(jnp.int64)
    blk = Block.from_dict({
        "k": Column(k, None, INT64),
        "v": Column(jnp.arange(N, dtype=jnp.int64), None, INT64,
                    stats=(0, N - 1)),
    })
    jax.block_until_ready(blk)
    plan = P.TopN([SortKey("k", desc=True, nulls_first=False)], 100,
                  P.TableScan("big", columns=["k", "v"]))

    def step(tables, carry):
        big = tables["big"]
        t2 = {"big": big.with_column("k", perturb_column(big["k"], carry))}
        out = execute_plan(plan, t2)
        return block_checksum(out) + carry * jnp.int64(0x9E3779B1)

    t = chain_seconds(step, {"big": blk}, 4, 12, vlog, "topn100m")
    return {
        "metric": "topn_100m_rows_per_s",
        "value": round(N / t / 1e6, 1),
        "unit": "Mrows/s",
        "t_iter_ms": round(t * 1e3, 3),
    }


def run_child(config: str, args) -> dict:
    """One config in THIS process (invoked as a subprocess)."""
    import jax

    import tiflash_jax  # noqa: F401  (x64 on)
    from tiflash_jax.runtime.device import enable_compile_cache
    from tiflash_jax.storage.tpch import generate_tpch

    if jax.default_backend() != "gpu":
        raise RuntimeError(f"no GPU found (JAX backend is "
                           f"{jax.default_backend()!r})")
    enable_compile_cache()

    def vlog(msg):
        if args.verbose:
            print(msg, file=sys.stderr, flush=True)

    if config == "topn100m":
        return bench_topn_100m(args, vlog)
    tables = ["lineitem"]
    if config == "q3":
        tables = ["lineitem", "orders", "customer"]
    t0 = time.perf_counter()
    cat = generate_tpch(sf=args.sf, seed=7, tables=tables)
    jax.block_until_ready(cat.blocks())
    vlog(f"gen+stage {time.perf_counter() - t0:.1f}s "
         f"rows={cat['lineitem'].row_count}")
    return bench_config(config, cat, args, vlog)


def orchestrate(args) -> int:
    """Parent: one subprocess per config, strictly one at a time; the
    parent never initialises a JAX backend.  The record so far is printed
    after every config (headline first), so that a kill at any point
    leaves a parseable last line.  Returns the exit code."""
    child_timeout = float(os.environ.get("BENCH_CHILD_TIMEOUT_S", "600"))
    configs = ALL_CONFIGS if args.config == "all" else [args.config]
    results: dict[str, dict] = {}
    failed = []

    def emit() -> None:
        head = dict(results[configs[0]])
        if len(configs) > 1:
            head["extra"] = {c: results[c] for c in configs[1:]
                             if c in results}
        print(json.dumps(head), flush=True)

    for cfg in configs:
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               "--config", cfg, "--sf", str(args.sf),
               "--k1", str(args.k1), "--k2", str(args.k2)]
        if args.verbose:
            cmd.append("--verbose")
        error = None
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                                  timeout=child_timeout)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                error = f"child exited {proc.returncode}"
            else:
                results[cfg] = json.loads(lines[-1])
        except subprocess.TimeoutExpired:
            error = f"child timed out after {child_timeout:.0f}s"
        if error is not None:
            print(f"[{cfg}] {error}", file=sys.stderr, flush=True)
            failed.append(cfg)
            results[cfg] = {"metric": f"{cfg}_failed", "error": error}
        emit()
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--config", default="all",
                    choices=["all"] + ALL_CONFIGS)
    ap.add_argument("--k1", type=int, default=8)
    ap.add_argument("--k2", type=int, default=32)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--child", action="store_true",
                    help="run the one --config in this process")
    args = ap.parse_args()
    if args.config == "all" or not args.child:
        return orchestrate(args)
    result = run_child(args.config, args)
    result.update(device_record())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
