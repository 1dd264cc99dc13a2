"""Time all 22 TPC-H plan shapes on the accelerator at a given SF.

Produces a markdown table (stderr progress, stdout table) — the
breadth-and-performance artifact: every reference TPC-H shape runs
end-to-end through the same plan compiler the service uses.

Methodology: carry-chain differencing like bench.py (one perturbed
int column per query's scanned fact table), shorter chains (K=4/12) —
table-grade precision, not headline-grade.

Usage: python tools/tpch_all.py [--sf 1.0]
"""

from __future__ import annotations

import argparse
import sys
import time


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=12)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import tiflash_jax  # noqa: F401
    from tiflash_jax.bench import tpch_queries as Q
    from tiflash_jax.plan.compiler import Diagnostics, execute_plan
    from tiflash_jax.plan.auto import autosize_plan
    from tiflash_jax.plan.rewrite import eager_aggregation, prune_columns
    from tiflash_jax.runtime.analyze import block_checksum, perturb_column
    from tiflash_jax.storage.tpch import generate_tpch

    t0 = time.time()
    cat = generate_tpch(sf=args.sf, seed=7)
    blocks = cat.blocks()
    jax.block_until_ready(blocks)
    log(f"gen+stage {time.time()-t0:.1f}s")

    # every query's perturbable int column on its biggest scanned table
    PERTURB = {"default": ("lineitem", "l_extendedprice")}
    SPECIAL = {
        "q2": ("partsupp", "ps_supplycost"),
        "q11": ("partsupp", "ps_availqty"),
        "q13": ("orders", "o_orderkey"),
        "q16": ("partsupp", "ps_suppkey"),
        "q22": ("customer", "c_acctbal"),
    }

    rows = []
    names = [f"q{i}" for i in range(1, 23)]
    for name in names:
        maker = getattr(Q, f"{name}_plan", None)
        if maker is None:
            rows.append((name, None, "no plan"))
            continue
        # capacities come from stats-derived auto-sizing (plan/auto.py),
        # not hand-tuned constants
        plan = prune_columns(eager_aggregation(maker()))
        autosize_plan(plan, cat.blocks())
        tbl, coln = SPECIAL.get(name, PERTURB["default"])

        @jax.jit
        def step(tables, carry, _plan=plan, _tbl=tbl, _coln=coln):
            t2 = dict(tables)
            t2[_tbl] = tables[_tbl].with_column(
                _coln, perturb_column(tables[_tbl][_coln], carry))
            diag = Diagnostics({}, {})
            out = execute_plan(_plan, t2, diag)
            ovf = jnp.int64(0)
            for v in diag.overflows.values():
                ovf = jnp.maximum(ovf, jnp.max(jnp.asarray(v)).astype(jnp.int64))
            return block_checksum(out) + carry * jnp.int64(0x9E3779B1), ovf

        seed = [hash(name) % 1000]

        def chain(K):
            seed[0] += 1
            c = jnp.int64(seed[0])
            ov = None
            t0 = time.time()
            for _ in range(K):
                c, ov = step(blocks, c)
            _ = int(c)
            return time.time() - t0, ov

        try:
            t0 = time.time()
            _, ov = chain(1)
            compile_s = time.time() - t0
            if int(ov) > 0:
                log(f"[{name}] OVERFLOW {int(ov)} — capacity too small")
                rows.append((name, None, f"overflow {int(ov)}"))
                continue
            chain(2)
            t1 = min(chain(args.k1)[0] for _ in range(2))
            t2 = min(chain(args.k2)[0] for _ in range(2))
            t = max((t2 - t1) / (args.k2 - args.k1), 1e-9)
            log(f"[{name}] compile {compile_s:.0f}s -> {t*1e3:.2f}ms")
            rows.append((name, t, ""))
        except Exception as e:
            log(f"[{name}] FAILED: {e!r}")
            rows.append((name, None, str(e)[:80]))

    print(f"\n| query | time @ SF{args.sf:g} (ms) | note |")
    print("|---|---|---|")
    for name, t, note in rows:
        ts = f"{t*1e3:.2f}" if t is not None else "—"
        print(f"| {name} | {ts} | {note} |")


if __name__ == "__main__":
    main()
