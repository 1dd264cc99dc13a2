"""Device timing for the brute-force vector search (ops/vector.py).

1M x 128 float32 corpus, 64 queries, k=100 — the scoring matrix product
plus batched top-k.  Carry-chain methodology from bench.py: every
iteration's queries are perturbed by the previous carry, every output
byte lands in the checksum, two chain lengths are differenced.

Run (one process per card):
  PYTHONPATH=. python tools/vector_bench.py [l2|cosine|inner_product]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import tiflash_jax  # noqa: F401  (x64 on)
from tiflash_jax.core.block import Column
from tiflash_jax.core.dtypes import Vector
from tiflash_jax.ops.vector import vector_search

N, D, Q, K = 1_000_000, 128, 64, 100


def main():
    metric = sys.argv[1] if len(sys.argv) > 1 else "l2"
    x = jax.random.normal(jax.random.PRNGKey(0), (N, D), dtype=jnp.float32)
    q0 = jax.random.normal(jax.random.PRNGKey(1), (Q, D), dtype=jnp.float32)
    col = Column(x, None, Vector(D))
    jax.block_until_ready((x, q0))

    @jax.jit
    def step(xcol, qbase, carry):
        # perturb queries from the carry -> real dispatch every iteration
        q = qbase + (carry.astype(jnp.float32) % 7.0) * 1e-6
        dist, idx = vector_search(xcol, q, K, metric=metric)
        return (jnp.sum(dist).astype(jnp.int64)
                + jnp.sum(idx.astype(jnp.int64))
                + carry * jnp.int64(0x9E3779B1))

    def chain(K_, seed):
        carry = jnp.int64(seed)
        t0 = time.time()
        for _ in range(K_):
            carry = step(col, q0, carry)
        _ = int(carry)
        return time.time() - t0

    t0 = time.time()
    chain(1, 1)
    print(f"[vec:{metric}] compile+first {time.time()-t0:.1f}s", flush=True)
    chain(2, 2)
    t1 = min(chain(4, 10 + i) for i in range(2))
    t2 = min(chain(12, 20 + i) for i in range(2))
    t = max((t2 - t1) / 8, 1e-9)
    qps = Q / t
    print(f"[vec:{metric}] t(4)={t1*1e3:.1f}ms t(12)={t2*1e3:.1f}ms "
          f"-> {t*1e3:.3f}ms/batch of {Q} = {t*1e6/Q:.1f}us/query, "
          f"{qps:,.0f} qps over {N:,}x{D}", flush=True)
    # roofline: one corpus read per batch (N*D*4 bytes) at HBM bw 819 GB/s
    bw = N * D * 4 / t / 1e9
    print(f"[vec:{metric}] effective corpus bandwidth {bw:.0f} GB/s "
          f"(HBM roofline 819)", flush=True)


if __name__ == "__main__":
    main()
