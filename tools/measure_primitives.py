"""Measure the primitive costs the operators are designed around: the
short-axis tile sort (the top-N primitive), flat 1-op and 2-op sorts, and
a packed row gather.

Methodology = bench.py's: carry-perturbed fused fori_loop chains, two
chain lengths differenced, checksummed outputs.  Run on the GPU:

    PYTHONPATH=. python tools/measure_primitives.py
"""

from __future__ import annotations

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp

import tiflash_jax  # noqa: F401  (x64 on)


def chain_time(step, init_arrays, k1=4, k2=12, log=lambda m: None):
    """t_iter via differenced fused carry chains (bench.py methodology)."""

    @functools.partial(jax.jit, static_argnums=2)
    def fused(arrays, carry, K):
        return jax.lax.fori_loop(0, K, lambda i, c: step(arrays, c), carry)

    seed = [0]

    def run(K):
        seed[0] += 1
        t0 = time.time()
        _ = int(fused(init_arrays, jnp.int64(seed[0]), K))
        return time.time() - t0

    t0 = time.time()
    run(k1); run(k2)
    log(f"  compile+first {time.time()-t0:.1f}s")
    while True:
        t1 = min(run(k1) for _ in range(2))
        t2 = min(run(k2) for _ in range(2))
        if (t2 - t1) >= 0.030 or k2 >= 512:
            break
        k1, k2 = k1 * 4, k2 * 4
        log(f"  rescale K to {k1}/{k2}")
    t = max((t2 - t1) / (k2 - k1), 1e-9)
    log(f"  t(K1)={t1*1e3:.1f}ms t(K2)={t2*1e3:.1f}ms -> {t*1e3:.3f}ms/iter")
    return t


def main():
    out = {}
    log = lambda m: print(m, file=sys.stderr, flush=True)

    key = jax.random.PRNGKey(3)

    def mk(n):
        return (jax.random.bits(key, (n,), dtype=jnp.uint64)
                >> jnp.uint64(1)).astype(jnp.int64)

    # 1) short-axis tile sort: (T, 2048) int64 along axis 1 — the topN
    # selection primitive (one pass over all rows)
    for n, tag in ((6_000_000, "tile_sort_6m"), (100_000_000, "tile_sort_100m")):
        T = n // 2048
        a = mk(T * 2048).reshape(T, 2048)
        jax.block_until_ready(a)

        def step(arrays, carry, _T=T):
            x = arrays[0] ^ (carry & jnp.int64(1))
            s = jax.lax.sort(x, dimension=1)
            return (jnp.sum(s[:, 0]) + jnp.sum(s[:, -1])
                    + carry * jnp.int64(0x9E3779B1))

        log(f"[{tag}] (T={T}, 2048) int64 axis-1 sort")
        t = chain_time(step, (a,), log=log)
        out[tag + "_ms"] = round(t * 1e3, 3)
        del a

    # 2) flat 1-op full sort 6M (the naive topN / order-by primitive)
    a = mk(6_000_000)
    jax.block_until_ready(a)

    def step_flat(arrays, carry):
        x = arrays[0] ^ (carry & jnp.int64(1))
        s = jax.lax.sort(x)
        return s[0] + s[-1] + carry * jnp.int64(0x9E3779B1)

    log("[flat_sort_6m]")
    out["flat_sort_6m_ms"] = round(chain_time(step_flat, (a,), log=log) * 1e3, 3)

    # 3) 2-operand key+perm sort 6M (the agg/join key-sort primitive)
    v = jnp.arange(6_000_000, dtype=jnp.int64)

    def step_2op(arrays, carry):
        x = arrays[0] ^ (carry & jnp.int64(1))
        k2, v2 = jax.lax.sort((x, arrays[1]), num_keys=1)
        return k2[0] + v2[0] + v2[-1] + carry * jnp.int64(0x9E3779B1)

    log("[sort2op_6m]")
    out["sort2op_6m_ms"] = round(chain_time(step_2op, (a, v), log=log) * 1e3, 3)

    # 4) packed row gather: (6M, 4) int64 rows gathered at 6M random ids
    ids = (jax.random.bits(jax.random.PRNGKey(9), (6_000_000,),
                           dtype=jnp.uint32) % jnp.uint32(6_000_000)
           ).astype(jnp.int32)
    mat = jnp.stack([a, v, a, v], axis=1)
    jax.block_until_ready((ids, mat))

    def step_gather(arrays, carry):
        m, i = arrays
        i2 = i ^ (carry & jnp.int64(1)).astype(jnp.int32)
        g = jnp.take(m, i2, axis=0)
        return jnp.sum(g[:, 0]) + jnp.sum(g[:, 3]) + carry * jnp.int64(0x9E3779B1)

    log("[gather_6m_k4]")
    out["gather_6m_k4_ms"] = round(
        chain_time(step_gather, (mat, ids), log=log) * 1e3, 3)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
