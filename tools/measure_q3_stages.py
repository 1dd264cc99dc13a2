"""Stage breakdown for the Q3 config (BASELINE config 2) on the GPU.

Q3's rewritten tree is TopN(Proj(Join(StreamAgg(lineitem), Proj(j1)))):
each --stage carves a prefix subtree and carry-chains it alone, so
differencing stages attributes time per operator (the EXPLAIN ANALYZE
subtree-differencing model, applied to the bench config):

    j1     = orders x customer join alone
    agg    = the lineitem StreamAgg subtree alone
    join   = everything but TopN
    full   = the whole plan
    final-join cost = join - agg - j1;   topN cost = full - join

--slots overrides the Aggregation capacity (0 = autosize from stats).

Host-dispatch carry chains: each iteration perturbs one input column
with the previous checksum, and two chain lengths are differenced.

    python tools/measure_q3_stages.py --stage full
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

import tiflash_jax  # noqa: F401  (x64 on)
from tiflash_jax.plan import nodes as P


def carve(plan, stage: str):
    """Return (subplan, perturb_table, perturb_col) for a stage name."""
    aggs = []
    joins = []

    def walk(n):
        if isinstance(n, P.Aggregation):
            aggs.append(n)
        if isinstance(n, P.Join):
            joins.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    agg = aggs[0]
    # j1 = the join with no Aggregation beneath it
    def has_agg(n):
        return isinstance(n, P.Aggregation) or any(has_agg(c) for c in n.children)

    j1 = next(j for j in joins if not has_agg(j))
    if stage == "full":
        return plan, "lineitem", "l_extendedprice"
    if stage == "join":
        return plan.children[0], "lineitem", "l_extendedprice"
    if stage == "agg":
        return agg, "lineitem", "l_extendedprice"
    if stage == "j1":
        return j1, "orders", "o_shippriority"
    raise ValueError(stage)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", required=True,
                    choices=["j1", "agg", "join", "full"])
    ap.add_argument("--slots", type=int, default=0,
                    help="override Aggregation.num_slots (0 = autosize)")
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=12)
    args = ap.parse_args()
    log = lambda m: print(m, file=sys.stderr, flush=True)

    from tiflash_jax.bench.tpch_queries import q3_plan
    from tiflash_jax.plan.auto import autosize_plan
    from tiflash_jax.plan.compiler import execute_plan
    from tiflash_jax.runtime.analyze import block_checksum, perturb_column
    from tiflash_jax.storage.tpch import generate_tpch

    t0 = time.time()
    cat = generate_tpch(sf=1.0, seed=7,
                        tables=["lineitem", "orders", "customer"])
    blocks = cat.blocks()
    jax.block_until_ready(blocks)
    log(f"gen+stage {time.time()-t0:.1f}s")

    plan = q3_plan()
    autosize_plan(plan, blocks)
    if args.slots:
        def setslots(n):
            if isinstance(n, P.Aggregation):
                n.num_slots = args.slots
            for c in n.children:
                setslots(c)
        setslots(plan)
    sub, ptable, pcol = carve(plan, args.stage)

    def bench_step(tables, carry):
        t2 = dict(tables)
        t2[ptable] = tables[ptable].with_column(
            pcol, perturb_column(tables[ptable][pcol], carry))
        out = execute_plan(sub, t2)
        return block_checksum(out) + carry * jnp.int64(0x9E3779B1)

    step = jax.jit(bench_step)
    seed = [0]

    def chain(K):
        seed[0] += 1
        carry = jnp.int64(seed[0] * 1000)
        t0 = time.time()
        for _ in range(K):
            carry = step(blocks, carry)
        _ = int(carry)
        return time.time() - t0

    t0 = time.time()
    chain(1)
    log(f"compile+first {time.time()-t0:.1f}s")
    t1 = min(chain(args.k1) for _ in range(2))
    t2 = min(chain(args.k2) for _ in range(2))
    t = max((t2 - t1) / (args.k2 - args.k1), 1e-9)
    slots = args.slots or "auto"
    print(json.dumps({"stage": args.stage, "slots": slots,
                      "ms_per_iter": round(t * 1e3, 2),
                      "t_k1_ms": round(t1 * 1e3, 1),
                      "t_k2_ms": round(t2 * 1e3, 1)}), flush=True)


if __name__ == "__main__":
    main()
