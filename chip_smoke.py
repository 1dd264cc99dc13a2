"""Bring-up check of the query engine on NVIDIA GPUs.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # the distributed path on four cards

One card, in one process:

1. refuses to run without a GPU;
2. prints the card's name and power limit (``nvidia-smi``) and JAX's
   device kind;
3. generates TPC-H at ``--sf`` (default 10) from ``--seed`` on the host and
   stages it on the card;
4. runs Q1, Q6, Q3 and ORDER BY l_extendedprice DESC LIMIT 100 through
   ``run_query`` and compares each answer with a plain numpy reference
   written in this file, which shares no code with the engine; prints each
   query's first-run time (trace, compile and run) and its steady-state
   time (median of ``--reps`` runs), and for Q1 and Q6 the floor that a
   copy bandwidth measured in the same process sets;
5. serves Q1 and Q3 through the HTTP query service and checks that the
   answers equal ``run_query``'s;
6. checks exact vector search (1M x 128, 64 queries, k=100) against a
   float64 reference.

With ``--four-cards`` it runs only the distributed phase, on a mesh of four
cards: both wire modes of the hash exchange, Q1 and Q3 through
``run_query(..., mesh=...)``, a skew-aware shuffle join under a 60%-hot
key and a laned window, each compared with the single-card answer from the
same process and with the numpy reference.

Exactness: decimal results are compared as integer mantissas (Python ints:
Q1's sum_charge at SF10 comes within a factor of ~6 of 2**63) and integers
exactly.  None of these queries returns a float64 column; one would be held
to 1e-12 relative.  Vector distances are float32 and are held to the
float64 reference's ranking, ties within 1e-6 relative.

Every phase must pass.  Only then is the last line of standard output
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import json
import os
import statistics
import sys
import time
import urllib.request
from typing import Callable, Dict, List, Tuple

import numpy as np

TPCH_TABLES = ["lineitem", "orders", "customer"]
Host = Dict[str, Dict[str, np.ndarray]]


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# plain numpy reference (shares no code with the engine)
# ---------------------------------------------------------------------------


def _day(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def exact_sum(x: np.ndarray) -> int:
    """Exact sum of an int64 array as a Python int (no int64 overflow)."""
    x = np.asarray(x, dtype=np.int64)
    return (int((x >> 32).sum()) << 32) + int((x & 0xFFFFFFFF).sum())


def _div_half_up(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def host_tables(cat) -> Tuple[Host, Dict[str, tuple]]:
    """Host copies of the catalog's columns, and the string dictionaries."""
    host: Host = {}
    dicts: Dict[str, tuple] = {}
    for name, table in cat.tables.items():
        host[name] = {}
        for cname, col in zip(table.block.names, table.block.columns):
            host[name][cname] = np.asarray(col.data)
            if col.dictionary is not None:
                dicts[cname] = tuple(col.dictionary)
    return host, dicts


def ref_q1(host: Host, dicts) -> Dict[str, list]:
    """Q1; decimals as mantissas: sums of scale 2, 2, 4, 6, averages of
    scale 6 rounded half up."""
    li = host["lineitem"]
    m = li["l_shipdate"] <= _day(1998, 9, 2)
    rf, ls = li["l_returnflag"][m], li["l_linestatus"][m]
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    disc, tax = li["l_discount"][m], li["l_tax"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    codes = np.unique(rf.astype(np.int64) * 1024 + ls)
    groups = sorted((dicts["l_returnflag"][c // 1024],
                     dicts["l_linestatus"][c % 1024], c // 1024, c % 1024)
                    for c in codes.tolist())
    out: Dict[str, list] = {k: [] for k in (
        "l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
        "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
        "count_order")}
    for rf_s, ls_s, a, b in groups:
        g = (rf == a) & (ls == b)
        n = int(g.sum())
        sq, sp, sd = exact_sum(qty[g]), exact_sum(price[g]), exact_sum(disc[g])
        out["l_returnflag"].append(rf_s)
        out["l_linestatus"].append(ls_s)
        out["sum_qty"].append(sq)
        out["sum_base_price"].append(sp)
        out["sum_disc_price"].append(exact_sum(disc_price[g]))
        out["sum_charge"].append(exact_sum(charge[g]))
        out["avg_qty"].append(_div_half_up(sq * 10**4, n))
        out["avg_price"].append(_div_half_up(sp * 10**4, n))
        out["avg_disc"].append(_div_half_up(sd * 10**4, n))
        out["count_order"].append(n)
    return out


def ref_q6(host: Host, dicts) -> Dict[str, list]:
    """Q6; revenue as a scale-4 mantissa."""
    li = host["lineitem"]
    disc = li["l_discount"]
    m = ((li["l_shipdate"] >= _day(1994, 1, 1))
         & (li["l_shipdate"] < _day(1995, 1, 1))
         & (disc >= 5) & (disc <= 7) & (li["l_quantity"] < 2400))
    return {"revenue": [exact_sum(li["l_extendedprice"][m] * disc[m])]}


def ref_q3(host: Host, dicts) -> Dict[str, np.ndarray]:
    """Every Q3 group (sorted by l_orderkey) with its revenue as a scale-4
    mantissa; ``check_q3`` takes the top 10 from these."""
    c, o, li = host["customer"], host["orders"], host["lineitem"]
    building = dicts["c_mktsegment"].index("BUILDING")
    cust_ok = np.zeros(int(c["c_custkey"].max()) + 1, dtype=bool)
    cust_ok[c["c_custkey"][c["c_mktsegment"] == building]] = True
    om = (o["o_orderdate"] < _day(1995, 3, 15)) & cust_ok[o["o_custkey"]]
    size = int(max(o["o_orderkey"].max(), li["l_orderkey"].max())) + 1
    order_ok = np.zeros(size, dtype=bool)
    order_ok[o["o_orderkey"][om]] = True
    odate = np.zeros(size, dtype=np.int64)
    odate[o["o_orderkey"][om]] = o["o_orderdate"][om]
    oprio = np.zeros(size, dtype=np.int64)
    oprio[o["o_orderkey"][om]] = o["o_shippriority"][om]
    lm = (li["l_shipdate"] > _day(1995, 3, 15)) & order_ok[li["l_orderkey"]]
    keys = li["l_orderkey"][lm]
    rev = li["l_extendedprice"][lm] * (100 - li["l_discount"][lm])
    order = np.argsort(keys, kind="stable")
    keys, rev = keys[order], rev[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) \
        if len(keys) else np.zeros(0, dtype=np.int64)
    gk = keys[starts]
    return {"l_orderkey": gk, "o_orderdate": odate[gk],
            "o_shippriority": oprio[gk],
            "revenue": np.add.reduceat(rev, starts) if len(keys)
            else np.zeros(0, dtype=np.int64)}


def ref_top100(host: Host, dicts) -> Dict[str, np.ndarray]:
    """Rows that may appear in ORDER BY l_extendedprice DESC LIMIT 100:
    every row priced at or above the 100th highest price."""
    li = host["lineitem"]
    price = li["l_extendedprice"]
    k = min(100, len(price))
    kth = np.partition(price, len(price) - k)[len(price) - k]
    m = price >= kth
    return {"l_orderkey": li["l_orderkey"][m], "l_extendedprice": price[m],
            "k": k}


def check_exact(got: Dict[str, list], want: Dict[str, list]) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in want:
        assert [int(v) if isinstance(v, (int, np.integer)) else v
                for v in got[name]] == list(want[name]), (
            name, got[name][:8], list(want[name])[:8])


def check_q3(got: Dict[str, list], groups: Dict[str, np.ndarray]) -> None:
    """Top 10 by (revenue desc, o_orderdate asc): the engine's sort keys
    must equal the reference's, and each row must be a real group."""
    rev, date = groups["revenue"], groups["o_orderdate"]
    order = np.lexsort((date, -rev))[:10]
    want_keys = [(int(rev[i]), int(date[i])) for i in order]
    got_keys = [(int(r), int(d)) for r, d in zip(got["revenue"],
                                                   got["o_orderdate"])]
    assert got_keys == want_keys, (got_keys, want_keys)
    gk = groups["l_orderkey"]
    for key, d, p, r in zip(got["l_orderkey"], got["o_orderdate"],
                            got["o_shippriority"], got["revenue"]):
        i = int(np.searchsorted(gk, key))
        assert i < len(gk) and gk[i] == key, ("no such group", key)
        assert (int(groups["o_orderdate"][i]), int(groups["o_shippriority"][i]),
                int(rev[i])) == (int(d), int(p), int(r)), key


def check_top100(got: Dict[str, list], cand: Dict[str, np.ndarray]) -> None:
    prices = [int(v) for v in got["l_extendedprice"]]
    want = sorted((int(v) for v in cand["l_extendedprice"]),
                  reverse=True)[:cand["k"]]
    assert prices == want, (prices[:5], want[:5])
    pairs = set(zip(cand["l_orderkey"].tolist(),
                    cand["l_extendedprice"].tolist()))
    for key, p in zip(got["l_orderkey"], prices):
        assert (int(key), p) in pairs, ("no such row", key, p)


REFERENCES: Dict[str, Tuple[Callable, Callable]] = {
    "q1": (ref_q1, check_exact),
    "q6": (ref_q6, check_exact),
    "q3": (ref_q3, check_q3),
    "top100": (ref_top100, check_top100),
}

# columns each scan-bound query reads: bytes read / copy bandwidth is its
# floor
COLS_READ = {
    "q1": ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate"],
    "q6": ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"],
}


def query_plans() -> Dict[str, Callable]:
    from tiflash_jax.bench.tpch_queries import (
        q1_plan, q3_plan, q6_plan, sort_topn_plan)

    return {"q1": q1_plan, "q6": q6_plan, "q3": q3_plan,
            "top100": lambda: sort_topn_plan(100)}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _median_seconds(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def load_tpch(sf: float, seed: int, device):
    """Generate on the host (JAX's CPU device), then stage on ``device``."""
    import jax

    from tiflash_jax.runtime.memory import device_memory_stats
    from tiflash_jax.storage.tpch import generate_tpch

    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        cat = generate_tpch(sf=sf, seed=seed, tables=TPCH_TABLES)
    gen_s = time.perf_counter() - t0
    host, dicts = host_tables(cat)
    t0 = time.perf_counter()
    staged = jax.block_until_ready(jax.device_put(cat.blocks(), device))
    stage_s = time.perf_counter() - t0
    for name, block in staged.items():
        cat.tables[name].block = block
    for leaf in jax.tree_util.tree_leaves(staged):
        assert leaf.devices() == {device}, leaf.devices()
    nbytes = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(staged))
    rows = {n: t.row_count for n, t in cat.tables.items()}
    log(f"tpch sf={sf:g} seed={seed}: rows {rows}; generated in {gen_s:.3f} s,"
        f" staged {nbytes} bytes in {stage_s:.3f} s;"
        f" device memory {device_memory_stats()}")
    return cat, host, dicts


def copy_bandwidth(reps: int) -> float:
    """Bytes/s of a jitted elementwise pass over a 1 GiB int64 array
    (reads and writes every byte)."""
    import jax
    import jax.numpy as jnp

    x = jnp.arange(1 << 27, dtype=jnp.int64)
    f = jax.jit(lambda a: a + 1)
    jax.block_until_ready(f(x))
    t = _median_seconds(lambda: jax.block_until_ready(f(x)), reps)
    return 2 * x.nbytes / t


def _timings(make, blocks, reps: int) -> Tuple[Dict[str, list], float, float]:
    """(answer, steady QueryRunner.run seconds, compiled program seconds)
    for one plan; the runner's first run compiles."""
    import jax

    from tiflash_jax.plan.compiler import compile_fragment
    from tiflash_jax.runtime.executor import QueryRunner

    runner = QueryRunner(make())
    out, _ = runner.run(blocks)
    steady = _median_seconds(lambda: runner.run(blocks), reps)
    frag = compile_fragment(runner.plan)
    jax.block_until_ready(frag(blocks))
    prog = _median_seconds(lambda: jax.block_until_ready(frag(blocks)), reps)
    return out.to_pylists(), steady, prog


def run_queries(cat, host, dicts, reps: int) -> Dict[str, Dict[str, list]]:
    """Every query through ``run_query`` against the numpy reference; the
    scan-bound ones also through the plain XLA path, which the fused
    scan-aggregate kernel must equal and beat."""
    import tiflash_jax.ops.scan_agg as scan_agg
    from tiflash_jax.runtime.executor import run_query

    blocks = cat.blocks()
    bw = copy_bandwidth(reps)
    log(f"copy bandwidth (1 GiB int64, median of {reps}): {bw / 1e9:.1f} GB/s")
    answers = {}
    for name, make in query_plans().items():
        t0 = time.perf_counter()
        out, _ = run_query(make(), blocks)
        first_s = time.perf_counter() - t0
        got = out.to_pylists()
        ref_fn, check = REFERENCES[name]
        t0 = time.perf_counter()
        want = ref_fn(host, dicts)
        ref_s = time.perf_counter() - t0
        check(got, want)
        answers[name] = got
        _, steady, prog = _timings(make, blocks, reps)
        line = (f"{name}: equals the numpy reference ({ref_s:.1f} s);"
                f" first run_query {first_s:.3f} s; steady QueryRunner.run"
                f" {steady * 1e3:.3f} ms, compiled program {prog * 1e3:.3f} ms"
                f" (medians of {reps})")
        if name in COLS_READ:
            li = cat["lineitem"].block
            nbytes = sum(li[c].data.nbytes for c in COLS_READ[name])
            floor = nbytes / bw
            fused_route = scan_agg.kernel_route
            scan_agg.kernel_route = lambda: None  # every chain takes the plain path
            try:
                plain, p_steady, p_prog = _timings(make, blocks, reps)
            finally:
                scan_agg.kernel_route = fused_route
            assert plain == got, (name, plain, got)
            line += (f"; plain XLA path: equal answer, QueryRunner.run"
                     f" {p_steady * 1e3:.3f} ms, program {p_prog * 1e3:.3f} ms;"
                     f" copy floor {floor * 1e3:.3f} ms ({nbytes} bytes):"
                     f" kernel {prog / floor:.2f}x, plain {p_prog / floor:.2f}x")
        log(line)
    return answers


def served_path(cat, answers) -> None:
    from tiflash_jax.mpp.service import QueryService, serve_background
    from tiflash_jax.plan.serde import plan_to_json

    plans = query_plans()
    # straight to the local server, whatever proxy the environment names
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    httpd, port = serve_background(QueryService(cat), 0)
    try:
        for name in ("q1", "q3"):
            body = json.dumps({"plan": plan_to_json(plans[name]())}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/query", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with opener.open(req, timeout=900) as resp:
                served = json.load(resp)
            wall = time.perf_counter() - t0
            want = json.loads(json.dumps(answers[name], default=str))
            assert served["columns"] == want, (name, served.get("error"))
            log(f"served {name}: POST /query on port {port} equals run_query"
                f" ({wall:.3f} s, first request of this plan)")
    finally:
        httpd.shutdown()
        httpd.server_close()


def vector_phase(reps: int) -> None:
    import jax

    from tiflash_jax.core.block import Column
    from tiflash_jax.core.dtypes import Vector
    from tiflash_jax.ops.vector import vector_search

    n, d, nq, k = 1_000_000, 128, 64, 100
    x = jax.random.uniform(jax.random.PRNGKey(11), (n, d), dtype=np.float32)
    q = jax.random.uniform(jax.random.PRNGKey(12), (nq, d), dtype=np.float32)
    col = Column(x, None, Vector(d))
    search = jax.jit(lambda c, qq: vector_search(c, qq, k))
    dist, idx = jax.block_until_ready(search(col, q))
    t = _median_seconds(lambda: jax.block_until_ready(search(col, q)), reps)
    x64, q64 = np.asarray(x, np.float64), np.asarray(q, np.float64)
    exact = np.sqrt(np.maximum(
        (x64 * x64).sum(1)[:, None] + (q64 * q64).sum(1)[None, :]
        - 2.0 * (x64 @ q64.T), 0.0))
    idx, dist = np.asarray(idx), np.asarray(dist)
    for j in range(nq):
        best = np.sort(np.partition(exact[:, j], k)[:k])
        got = exact[idx[j], j]
        np.testing.assert_allclose(got, best, rtol=1e-6)
        np.testing.assert_allclose(dist[j], got, rtol=1e-5, atol=1e-5)
    log(f"vector search {n}x{d}, {nq} queries, k={k}: rankings equal the"
        f" float64 reference; {t * 1e3:.3f} ms per batch (median of {reps})")


def one_card(args) -> None:
    import jax

    device = jax.devices()[0]
    cat, host, dicts = load_tpch(args.sf, args.seed, device)
    answers = run_queries(cat, host, dicts, args.reps)
    served_path(cat, answers)
    vector_phase(args.reps)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

WIRE_MODES = ("ragged", "padded")
# rows of the synthetic tables of the four-card phase
WIRE_ROWS = 1 << 22
SKEW_PROBE_ROWS, SKEW_BUILD_ROWS = 1 << 22, 1 << 20
WINDOW_ROWS = 1 << 22


def _rows(block, names: List[str]) -> np.ndarray:
    """Live rows of a block as a lexicographically sorted (n, len(names))
    int64 array (the columns hold no NULLs)."""
    live = np.asarray(block.sel_mask())
    arr = np.stack([np.asarray(block[n].data)[live].astype(np.int64)
                    for n in names], axis=1)
    return arr[np.lexsort(arr.T[::-1])]


def _int_block(**cols: Tuple[np.ndarray, object]):
    """A table of non-NULL integer columns with their value ranges."""
    import jax.numpy as jnp

    from tiflash_jax.core.block import Block, Column

    return Block.from_dict({
        n: Column(jnp.asarray(a), None, t, stats=(int(a.min()), int(a.max())))
        for n, (a, t) in cols.items()})


def _per_device_live(block) -> List[int]:
    return [int(np.asarray(s.data).sum())
            for s in block.sel_mask().addressable_shards]


def wire_modes(mesh, n: int, pool) -> Callable[[], None]:
    """The hash exchange's two wire strategies move the same rows.  Builds
    the table, hands the programs' compiles to ``pool`` and returns the
    phase that runs them."""
    import jax
    from jax.sharding import PartitionSpec as PSpec

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.exchange.shuffle import shuffle_block, wire_mode
    from tiflash_jax.mpp.runner import shard_block

    rng = np.random.default_rng(3)
    k = rng.integers(0, n // 8, n)
    v = np.arange(n, dtype=np.int64)
    block = shard_block(_int_block(k=(k, dt.INT64), v=(v, dt.INT64)), mesh)
    cap = 2 * (n // mesh.size)
    programs = {}
    for mode in WIRE_MODES:
        def f(b, mode=mode):
            out, ov = shuffle_block(b, ["k"], "d", cap, mode=mode)
            return out, jax.lax.pmax(ov, "d")
        fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(PSpec("d"),),
                                   out_specs=(PSpec("d"), PSpec()),
                                   check_vma=False))
        programs[mode] = pool.submit(_compiled, fn, block)

    def run() -> None:
        got = {}
        for mode in WIRE_MODES:
            out, ov = programs[mode].result()(block)
            assert int(ov) == 0, (mode, int(ov))
            per_dev = []
            for i in range(mesh.size):
                s = slice(i * cap, (i + 1) * cap)
                live = np.asarray(out.sel_mask())[s]
                rows = np.stack([np.asarray(out["k"].data)[s][live],
                                 np.asarray(out["v"].data)[s][live]], axis=1)
                per_dev.append(rows[np.lexsort(rows.T[::-1])])
            got[mode] = per_dev
            every = np.concatenate(per_dev)
            assert sorted(every[:, 1].tolist()) == v.tolist(), mode
            log(f"wire mode {mode}: {n} rows exchanged, per-device rows"
                f" {[len(r) for r in per_dev]}")
        for mode in WIRE_MODES[1:]:
            for a, b in zip(got[WIRE_MODES[0]], got[mode]):
                assert np.array_equal(a, b), mode
        log(f"wire modes {list(WIRE_MODES)} deliver the same rows to every"
            f" device; 'auto' on {jax.default_backend()} is"
            f" '{wire_mode(jax.default_backend())}'")

    return run


def _compiled(fn, *args):
    """``fn`` compiled for ``args``, without running it."""
    return fn.lower(*args).compile()


def _mesh_query_program(name: str, blocks, mesh, pool):
    """Hand to ``pool`` the compile, without a run, of the mesh program
    that ``run_query(plan, blocks, mesh=mesh)`` builds for query ``name``:
    the same distribution, sizing and exchange settings, so that the
    program lands in JAX's persistent compilation cache and ``run_query``
    loads it from there.  Sizing samples the tables on the cards, so it
    runs here, on the calling thread."""
    from tiflash_jax.mpp.runner import (
        ExchangeConfig, compile_distributed, shard_catalog_blocks)
    from tiflash_jax.plan.auto import autosize_plan, distribute_plan
    from tiflash_jax.runtime.settings import Settings

    settings = Settings()
    plan = distribute_plan(query_plans()[name](),
                           {t: b.capacity for t, b in blocks.items()},
                           mesh.size)
    sharded = shard_catalog_blocks(blocks, mesh)
    autosize_plan(plan, sharded, settings=settings)
    cfg = ExchangeConfig(shuffle_factor=settings.default_shuffle_factor,
                         rf_in_set_max_build=settings.rf_in_set_max_build)
    return pool.submit(_compiled, compile_distributed(
        plan, mesh, axis=settings.mesh_axis, cfg=cfg), sharded)


def _distributed_query(name: str, cat, host, dicts, mesh, program) -> None:
    """One TPC-H query through ``run_query`` on one card and on the mesh,
    each against the numpy reference, and the two against each other;
    ``program`` is the mesh program's compile (``_mesh_query_program``)."""
    from tiflash_jax.runtime.executor import run_query

    ref_fn, check = REFERENCES[name]
    want = ref_fn(host, dicts)
    single, _ = run_query(query_plans()[name](), cat.blocks())
    single = single.to_pylists()
    check(single, want)
    program.result()
    t0 = time.perf_counter()
    dist, summary = run_query(query_plans()[name](), cat.blocks(), mesh=mesh)
    wall = time.perf_counter() - t0
    got = dist.to_pylists()
    check(got, want)
    assert sorted(zip(*got.values())) == sorted(zip(*single.values())), name
    log(f"distributed {name} on {summary.num_devices} cards equals the"
        f" single-card answer and the numpy reference (first run_query"
        f" {wall:.3f} s after its compile on a worker thread,"
        f" {summary.retries} capacity retries)")


def _skew_join(mesh, pool) -> Callable[[], None]:
    """A skew-aware shuffle join, 60% of probe rows on one key.  Builds the
    tables, hands the mesh program's compile to ``pool`` and returns the
    phase that runs it."""
    import jax

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.mpp.runner import (
        ExchangeConfig, collect_result, compile_distributed,
        shard_catalog_blocks)
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.executor import run_query

    n_probe, n_build = SKEW_PROBE_ROWS, SKEW_BUILD_ROWS
    rng = np.random.default_rng(5)
    hot = int(n_probe * 0.6)
    lk = np.concatenate([np.full(hot, 7, np.int64),
                         rng.integers(0, n_build, n_probe - hot)])
    lv = np.arange(n_probe, dtype=np.int64) % 11
    rk = np.arange(n_build, dtype=np.int64)
    rv = rk * 3 % 1000
    tables = {"l": _int_block(lk=(lk, dt.INT64), lv=(lv, dt.INT64)),
              "r": _int_block(rk=(rk, dt.INT64), rv=(rv, dt.INT64))}
    sharded = shard_catalog_blocks(tables, mesh)
    skew = P.SkewShuffleJoin(
        kind="inner", probe_keys=["lk"], build_keys=["rk"],
        probe=P.TableScan("l"), build=P.TableScan("r"),
        output_capacity=n_probe)
    program = pool.submit(_compiled, compile_distributed(
        skew, mesh, cfg=ExchangeConfig(shuffle_factor=4.0)), sharded)

    def run() -> None:
        names = ["lk", "lv", "rk", "rv"]
        want = np.stack([lk, lv, lk, rv[lk]], axis=1)
        want = want[np.lexsort(want.T[::-1])]
        single, _ = run_query(P.Join(
            kind="inner", probe_keys=["lk"], build_keys=["rk"],
            probe=P.TableScan("l"), build=P.TableScan("r"),
            unique_build=True), tables)
        assert np.array_equal(_rows(single, names), want)
        out, ov = program.result()(sharded)
        jax.block_until_ready(out)
        assert all(int(np.asarray(v).max()) == 0 for v in ov.values()), ov
        per_dev = _per_device_live(out)
        assert np.array_equal(_rows(collect_result(out), names), want)
        log(f"skew join ({n_probe} probe rows, 60% on one key, {n_build}"
            f" build rows) equals the single-card join and the numpy"
            f" reference; per-device joined rows {per_dev}, max share"
            f" {max(per_dev) / sum(per_dev):.3f}")

    return run


def _laned_window(mesh, pool) -> Callable[[], None]:
    """A window over a low-cardinality PARTITION BY, split into order
    lanes.  Builds the table, hands the mesh program's compile to ``pool``
    and returns the phase that runs it."""
    import jax

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.mpp.runner import (
        ExchangeConfig, collect_result, compile_distributed,
        shard_catalog_blocks)
    from tiflash_jax.ops.sort import SortKey
    from tiflash_jax.ops.window import WindowDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.auto import distribute_plan
    from tiflash_jax.runtime.executor import run_query

    n_w = WINDOW_ROWS
    i = np.arange(n_w, dtype=np.int64)
    wt = {"t": _int_block(p=((i % 2).astype(np.int32), dt.INT32),
                          o=(i, dt.INT64), v=(i % 7, dt.INT64))}
    wplan = P.Window(["p"], [SortKey("o")],
                     [WindowDesc("row_number", "rn"),
                      WindowDesc("sum", "rs", arg="v")],
                     P.TableScan("t"))
    wdist = distribute_plan(wplan, {"t": n_w}, mesh.size, tables=wt)
    assert "LanedWindow" in wdist.pretty(), wdist.pretty()
    sharded = shard_catalog_blocks(wt, mesh)
    program = pool.submit(_compiled, compile_distributed(
        wdist, mesh, cfg=ExchangeConfig(shuffle_factor=6.0)), sharded)

    def run() -> None:
        names = ["p", "o", "v", "rn", "rs"]
        want = np.stack([i % 2, i, i % 7, i // 2 + 1,
                         np.zeros(n_w, np.int64)], axis=1)
        for p in (0, 1):
            want[p::2, 4] = np.cumsum(want[p::2, 2])
        want = want[np.lexsort(want.T[::-1])]
        single, _ = run_query(wplan, wt)
        assert np.array_equal(_rows(single, names), want)
        out, ov = program.result()(sharded)
        jax.block_until_ready(out)
        assert all(int(np.asarray(v).max()) == 0 for v in ov.values()), ov
        per_dev = _per_device_live(out)
        assert np.array_equal(_rows(collect_result(out), names), want)
        log(f"laned window ({n_w} rows, 2 partitions) equals the"
            f" single-card window and the numpy reference; per-device live"
            f" rows {per_dev}")

    return run


def four_cards(args) -> None:
    """Every mesh program compiles on a worker thread, all at once:
    compiling takes most of this phase's time (minutes per mesh program
    on the cards).  Every program runs on this thread, one after another:
    two mesh programs launched at once from two threads can deadlock in
    their collectives."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    assert len(devices) >= 4, f"--four-cards needs 4 devices, found {devices}"
    mesh = Mesh(np.array(devices[:4]), ("d",))
    cat, host, dicts = load_tpch(args.sf, args.seed, devices[0])
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        programs = {name: _mesh_query_program(name, cat.blocks(), mesh, pool)
                    for name in ("q1", "q3")}
        later = [wire_modes(mesh, WIRE_ROWS, pool), _skew_join(mesh, pool),
                 _laned_window(mesh, pool)]
        for name in ("q1", "q3"):
            _distributed_query(name, cat, host, dicts, mesh, programs[name])
        for run in later:
            run()


# ---------------------------------------------------------------------------


def _entries(path: str) -> int:
    return len(os.listdir(path)) if os.path.isdir(path) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on four cards")
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per measurement (median)")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU found (JAX backend is "
              f"{jax.default_backend()!r}); nothing was run", file=sys.stderr)
        return 2
    import tiflash_jax  # noqa: F401  (x64 on)
    from tiflash_jax.runtime.device import card_line, enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: platform {dev.platform}, device_kind"
        f" {dev.device_kind!r}, {len(jax.devices())} device(s)")
    log(f"compile cache {cache}: {_entries(cache)} entries at start")
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(args)
    else:
        one_card(args)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s;"
        f" compile cache: {_entries(cache)} entries at end")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
