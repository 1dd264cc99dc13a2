"""approx_count_distinct — KMV mergeable sketch (the
AggregateFunctions/AggregateFunctionUniq.h HLL-family analog, redesigned
scatter-free; see ops/sketch.py)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block, Column
from tiflash_jax.ops.aggregate import AggDesc, hash_aggregate
from tiflash_jax.ops.sketch import SKETCH_K, kmv_candidates, kmv_estimate
from tiflash_jax.plan import nodes as P
from tiflash_jax.testing import oracle as O


def make_block(values, nulls=()):
    data = jnp.asarray(np.asarray(values, dtype=np.int64))
    validity = None
    if nulls:
        v = np.ones(len(values), dtype=bool)
        v[list(nulls)] = False
        validity = jnp.asarray(v)
    return Block(names=("x",), columns=(
        Column(data, validity, dt.INT64.with_nullable(bool(nulls))),))


def run_scalar(block):
    out = hash_aggregate(block, [], [AggDesc("approx_count_distinct", "x", "d")])
    return int(np.asarray(out.block["d"].data)[0])


def test_exact_below_k():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 500, 20_000)  # 500 distinct << k
    assert run_scalar(make_block(vals)) == len(set(vals.tolist()))


def test_nulls_excluded():
    got = run_scalar(make_block([1, 2, 2, 3, 99], nulls=[4]))
    assert got == 3


def test_estimate_above_k_within_tolerance():
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 200_000, 600_000)
    truth = len(set(vals.tolist()))
    got = run_scalar(make_block(vals))
    tol = 5.0 / math.sqrt(SKETCH_K)  # ~3 sigma
    assert abs(got - truth) <= tol * truth, (got, truth)


def test_kmv_merge_equals_global():
    """Sketch of a union == sketch over merged candidates (mergeability —
    the uniq-state merge analog)."""
    rng = np.random.default_rng(11)
    a = jnp.asarray(rng.integers(0, 2**61, 300_000, dtype=np.int64))
    b = jnp.asarray(rng.integers(0, 2**61, 300_000, dtype=np.int64))
    live_a = jnp.ones(a.shape[0], dtype=bool)
    ca = kmv_candidates(a, live_a)
    cb = kmv_candidates(b, live_a)
    merged = kmv_candidates(jnp.concatenate([ca, cb]),
                            jnp.ones(2 * SKETCH_K, dtype=bool))
    direct = kmv_candidates(jnp.concatenate([a, b]),
                            jnp.ones(2 * a.shape[0], dtype=bool))
    assert np.array_equal(np.asarray(merged), np.asarray(direct))
    assert int(kmv_estimate(merged)) == int(kmv_estimate(direct))


def test_grouped_approx_is_exact_per_group():
    rng = np.random.default_rng(13)
    n = 5000
    table = {"g": rng.integers(0, 7, n).tolist(),
             "x": rng.integers(0, 50, n).tolist()}
    schema = {"g": dt.INT32, "x": dt.INT64}
    block = O.pytable_to_block(table, schema)
    res = hash_aggregate(block, ["g"],
                         [AggDesc("approx_count_distinct", "x", "d")])
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(table, ["g"],
                         [("approx_count_distinct", "x", "d")])
    O.assert_tables_equal(got, want)


@pytest.fixture(scope="module")
def mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("d",))


def test_distributed_sketch_scalar(mesh):
    """Pure-scalar approx over a mesh: k-row sketch exchange, final
    re-sketch.  Must match the single-device estimate exactly (the sketch
    is deterministic) and the truth within tolerance."""
    from tiflash_jax.mpp.runner import (
        collect_result, compile_distributed, shard_catalog_blocks,
    )
    from tiflash_jax.plan.distribute import split_aggregation

    rng = np.random.default_rng(17)
    vals = rng.integers(0, 60_000, 200_000)
    truth = len(set(vals.tolist()))
    blocks = {"t": make_block(vals)}
    plan = split_aggregation([], [AggDesc("approx_count_distinct", "x", "d")],
                             P.TableScan("t"))
    fn = compile_distributed(plan, mesh)
    out, overflows = fn(shard_catalog_blocks(blocks, mesh))
    assert not any(bool(np.asarray(v).max()) for v in overflows.values())
    got = int(O.block_to_pytable(collect_result(out))["d"][0])
    tol = 5.0 / math.sqrt(SKETCH_K)
    assert abs(got - truth) <= tol * truth, (got, truth)


def test_distributed_grouped_approx_colocates(mesh):
    from tiflash_jax.mpp.runner import (
        collect_result, compile_distributed, shard_catalog_blocks,
    )
    from tiflash_jax.plan.distribute import split_aggregation

    rng = np.random.default_rng(19)
    n = 4096
    table = {"g": rng.integers(0, 5, n).tolist(),
             "x": rng.integers(0, 40, n).tolist()}
    schema = {"g": dt.INT32, "x": dt.INT64}
    blocks = {"t": O.pytable_to_block(table, schema)}
    from tiflash_jax.mpp.runner import ExchangeConfig

    plan = split_aggregation(["g"], [AggDesc("approx_count_distinct", "x", "d")],
                             P.TableScan("t"))
    fn = compile_distributed(plan, mesh,
                             cfg=ExchangeConfig(shuffle_factor=8.0))
    out, overflows = fn(shard_catalog_blocks(blocks, mesh))
    assert not any(bool(np.asarray(v).max()) for v in overflows.values())
    got = O.block_to_pytable(collect_result(out))
    want = O.o_aggregate(table, ["g"], [("approx_count_distinct", "x", "d")])
    O.assert_tables_equal(got, want)


def test_string_sketch_value_hashing():
    """String NDV must hash values, not dictionary codes."""
    table = {"x": ["apple", "pear", "apple", "fig", "pear", "kiwi"]}
    block = O.pytable_to_block(table, {"x": dt.STRING})
    out = hash_aggregate(block, [], [AggDesc("approx_count_distinct", "x", "d")])
    assert int(np.asarray(out.block["d"].data)[0]) == 4
