"""Sub-device window lanes (VERDICT r2 item 7): when PARTITION BY has
fewer distinct keys than devices (or is empty), partitions split into
order-key-range lanes with boundary stitching — the fine-grained-shuffle
analog (Flash/Mpp/FineGrainedShuffleWriter.cpp)."""

import numpy as np
import pytest

import jax
import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block, column_from_numpy
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.ops.window import WindowDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.auto import distribute_plan
from tiflash_jax.mpp.runner import (collect_result, compile_distributed,
                                    shard_catalog_blocks)
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.testing import oracle as O


@pytest.fixture(scope="module")
def mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]), ("d",))


FUNCS = [
    WindowDesc("row_number", "rn"),
    WindowDesc("rank", "rk"),
    WindowDesc("dense_rank", "dr"),
    WindowDesc("sum", "rs", arg="v"),       # running sum
    WindowDesc("count", "rc", arg="v"),     # running count
    WindowDesc("min", "rmin", arg="v"),     # running min (VERDICT r3 #6)
    WindowDesc("max", "rmax", arg="v"),     # running max
    WindowDesc("avg", "ravg", arg="v"),     # running avg (sum+count carries)
]


def _run_both(tables, partition_by, mesh, order=None):
    from tiflash_jax.mpp.runner import ExchangeConfig

    order = order or [SortKey("o")]
    plan = P.Window(partition_by, order, FUNCS, P.TableScan("t"))
    single, _ = compile_fragment(plan)(tables)
    stats = {k: b.capacity for k, b in tables.items()}
    dist = distribute_plan(plan, stats, 8, tables=tables)
    assert "LanedWindow" in dist.pretty(), dist.pretty()
    fn = compile_distributed(dist, mesh, cfg=ExchangeConfig(shuffle_factor=6.0))
    out, ov = fn(shard_catalog_blocks(tables, mesh))
    for k, v in ov.items():
        assert not bool(np.asarray(v).max()), k
    return single, collect_result(out), dist


def _sorted_rows(block, keys):
    t = O.block_to_pytable(block.compact())
    cols = sorted(t)
    rows = sorted(zip(*[t[c] for c in cols]),
                  key=lambda r: tuple((x is None, x) for x in r))
    return cols, rows


def test_two_partitions_eight_devices(mesh):
    rng = np.random.default_rng(47)
    n = 5000
    vvals = [None if rng.random() < 0.1 else int(x)
             for x in rng.integers(0, 100, n)]
    tables = {"t": O.pytable_to_block(
        {"p": [int(x) for x in rng.integers(0, 2, n)],
         "o": [int(x) for x in rng.integers(0, 10_000, n)],
         "v": vvals},
        {"p": dt.INT32, "o": dt.INT64, "v": dt.INT64.with_nullable(True)})}
    single, dist, dplan = _run_both(tables, ["p"], mesh)
    # the lane split must actually fan wider than the 2 partitions
    import re

    m = re.search(r"lanes=(\d+)", dplan.pretty())
    assert m and int(m.group(1)) >= 4, dplan.pretty()
    assert _sorted_rows(single, None) == _sorted_rows(dist, None)


def test_empty_partition_by(mesh):
    rng = np.random.default_rng(53)
    n = 4000
    tables = {"t": O.pytable_to_block(
        {"o": [int(x) for x in rng.integers(-500, 500, n)],
         "v": [int(x) for x in rng.integers(0, 7, n)]},
        {"o": dt.INT64, "v": dt.INT64})}
    single, dist, _ = _run_both(tables, [], mesh)
    assert _sorted_rows(single, None) == _sorted_rows(dist, None)


def test_desc_order_and_ties(mesh):
    rng = np.random.default_rng(59)
    n = 4000
    # heavy ties: rank/dense_rank boundaries are the hard part
    tables = {"t": O.pytable_to_block(
        {"p": [int(x) for x in rng.integers(0, 3, n)],
         "o": [int(x) for x in rng.integers(0, 40, n)],
         "v": [int(x) for x in rng.integers(0, 9, n)]},
        {"p": dt.INT32, "o": dt.INT64, "v": dt.INT64})}
    single, dist, _ = _run_both(tables, ["p"], mesh,
                                order=[SortKey("o", desc=True)])
    assert _sorted_rows(single, None) == _sorted_rows(dist, None)


EXT_FUNCS = [
    WindowDesc("percent_rank", "pr"),
    WindowDesc("cume_dist", "cd"),
    WindowDesc("ntile", "nt", offset=5),
    WindowDesc("lead", "ld", arg="v", offset=3),
    WindowDesc("lag", "lg", arg="v", offset=7),
    WindowDesc("lead", "ldd", arg="v", offset=2, default=-1),
    WindowDesc("first_value", "fv", arg="v"),
    WindowDesc("last_value", "lv", arg="v"),
    WindowDesc("nth_value", "nv", arg="v", offset=4),
    WindowDesc("sum", "fs", arg="v", frame=(5, 3)),
    WindowDesc("count", "fc", arg="v", frame=(2, 9)),
    WindowDesc("min", "fmin", arg="v", frame=(6, 2)),
    WindowDesc("max", "fmax", arg="v", frame=(0, 4)),
    WindowDesc("avg", "fav", arg="v", frame=(4, 4)),
]


def _run_ext(tables, partition_by, mesh, order=None):
    from tiflash_jax.mpp.runner import ExchangeConfig

    order = order or [SortKey("o")]
    plan = P.Window(partition_by, order, EXT_FUNCS, P.TableScan("t"))
    single, _ = compile_fragment(plan)(tables)
    stats = {k: b.capacity for k, b in tables.items()}
    dist = distribute_plan(plan, stats, 8, tables=tables)
    assert "LanedWindow" in dist.pretty(), dist.pretty()
    fn = compile_distributed(dist, mesh,
                             cfg=ExchangeConfig(shuffle_factor=6.0))
    out, ov = fn(shard_catalog_blocks(tables, mesh))
    for k, v in ov.items():
        assert not bool(np.asarray(v).max()), k
    return single, collect_result(out)


def _ext_tables(seed, n=4000, parts=2, null_prob=0.12):
    """UNIQUE order keys: lead/lag/nth pick rows by position, which is
    only deterministic without order-key ties (MySQL likewise)."""
    rng = np.random.default_rng(seed)
    o = rng.permutation(n * 3)[:n]
    vvals = [None if rng.random() < null_prob else int(x)
             for x in rng.integers(-50, 100, n)]
    return {"t": O.pytable_to_block(
        {"p": [int(x) for x in rng.integers(0, parts, n)],
         "o": [int(x) for x in o],
         "v": vvals},
        {"p": dt.INT32, "o": dt.INT64,
         "v": dt.INT64.with_nullable(True)})}


def test_extended_family_parity(mesh):
    """lead/lag/first/last/nth/ntile/percent_rank/cume_dist + bounded
    ROWS frames through the laned path == the single-device window
    (VERDICT r4 item 3: fine-grained shuffle at full breadth)."""
    tables = _ext_tables(101)
    single, dist = _run_ext(tables, ["p"], mesh)
    sc, sr = _sorted_rows(single, None)
    dc, drows = _sorted_rows(dist, None)
    assert sc == dc
    assert sr == drows


def test_extended_family_desc_and_empty_partition(mesh):
    tables = _ext_tables(202, parts=1)
    single, dist = _run_ext(tables, [], mesh,
                            order=[SortKey("o", desc=True)])
    sc, sr = _sorted_rows(single, None)
    dc, drows = _sorted_rows(dist, None)
    assert sc == dc
    assert sr == drows


def test_laned_decline_note(mesh):
    """A declined lane split says WHY in the plan (VERDICT r4 weak 7)."""
    tables = _ext_tables(303)
    plan = P.Window(["p"], [SortKey("o")],
                    [WindowDesc("sum", "s", arg="v",
                                frame=(5, 3), frame_type="range")],
                    P.TableScan("t"))
    stats = {k: b.capacity for k, b in tables.items()}
    dist = distribute_plan(plan, stats, 8, tables=tables)
    assert "laned window declined" in dist.pretty(), dist.pretty()
