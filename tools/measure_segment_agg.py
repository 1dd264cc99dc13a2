"""Time the direct aggregation's XLA segment path on the accelerator.

The direct method (``ops/aggregate.aggregate_direct``) accumulates
domains above ``MASKED_DOMAIN_LIMIT`` slots with an unsorted scatter-add
(``segment_sum``).  This times it at 60M rows, with sum/count/avg over an
int64 decimal column, for 256 and 65,536 slots, beside the sort method
that ``hash_aggregate`` takes above ``DIRECT_DOMAIN_LIMIT`` and the floor
that a copy bandwidth measured in the same process sets for the bytes the
aggregation reads (int32 slot ids and int64 values).

    PYTHONPATH=. python tools/measure_segment_agg.py [--rows 60000000] [--reps 5]

Prints one line per measurement and a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def median_s(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import tiflash_jax  # noqa: F401  (x64 on)
    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.core.block import Block, Column
    from tiflash_jax.ops.aggregate import (
        AggDesc, aggregate_direct, aggregate_sort, pack_keys_direct)
    from tiflash_jax.runtime.device import card_line, enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"card: {card_line()}; device_kind {dev.device_kind!r}", flush=True)
    n, reps = args.rows, args.reps
    x = jnp.arange(1 << 27, dtype=jnp.int64)
    copy = jax.jit(lambda a: a + 1)
    jax.block_until_ready(copy(x))
    bw = 2 * x.nbytes / median_s(lambda: jax.block_until_ready(copy(x)), reps)
    print(f"copy bandwidth: {bw / 1e9:.1f} GB/s", flush=True)
    del x

    key = jax.random.PRNGKey(0)
    vals = jax.random.randint(key, (n,), -10**9, 10**9, dtype=jnp.int64)
    aggs = [AggDesc("sum", "v", "s"), AggDesc("count", None, "c"),
            AggDesc("avg", "v", "a")]
    out = {"rows": n, "copy_GBps": bw / 1e9}
    for domain in (256, 65536):
        slots = jax.random.randint(jax.random.PRNGKey(domain), (n,), 0, domain,
                                   dtype=jnp.int32)
        block = Block.from_dict({
            "k": Column(slots, None, dt.STRING,
                        tuple(f"{i:06d}" for i in range(domain))),
            "v": Column(vals, None, dt.Decimal(15, 2))})
        floor = (slots.nbytes + vals.nbytes) / bw

        direct = jax.jit(lambda b: aggregate_direct(
            b, ["k"], aggs, pack_keys_direct([b["k"]])).block)
        jax.block_until_ready(direct(block))
        t = median_s(lambda: jax.block_until_ready(direct(block)), reps)
        print(f"segment path, {domain} slots: {t * 1e3:.3f} ms"
              f" (copy floor {floor * 1e3:.3f} ms, ratio {t / floor:.2f})",
              flush=True)
        out[f"segment_{domain}_ms"] = t * 1e3
        out[f"floor_{domain}_ms"] = floor * 1e3

        sort = jax.jit(lambda b: aggregate_sort(b, ["k"], aggs, domain).block)
        jax.block_until_ready(sort(block))
        t = median_s(lambda: jax.block_until_ready(sort(block)), reps)
        print(f"sort method, {domain} slots: {t * 1e3:.3f} ms", flush=True)
        out[f"sort_{domain}_ms"] = t * 1e3
    print(json.dumps(out))


if __name__ == "__main__":
    main()
