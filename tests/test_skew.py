"""Skew-aware shuffle join tests: correctness under heavy key skew, and
the no-overflow property that motivates it (a hot key must NOT have to
fit through one device's shuffle chunk)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tiflash_jax.core.dtypes as dt
from tiflash_jax.exchange.skew import concat_blocks, detect_hot_keys
from tiflash_jax.mpp.runner import (
    ExchangeConfig,
    collect_result,
    compile_distributed,
    shard_catalog_blocks,
)
from tiflash_jax.plan import nodes as P
from tiflash_jax.testing import oracle as O


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), ("d",))


def skewed_tables(mesh, nl=1600, nr=128, hot_frac=0.6, seed=0):
    """60% of probe rows share one key; the rest are uniform."""
    rng = np.random.default_rng(seed)
    hot_n = int(nl * hot_frac)
    lk = np.concatenate([
        np.full(hot_n, 7), rng.integers(100, 1000, nl - hot_n)
    ]).astype(np.int64)
    rng.shuffle(lk)
    lt = {"lk": lk.tolist(), "lv": list(range(nl))}
    rk = np.concatenate([[7], rng.integers(100, 1000, nr - 1)]).astype(np.int64)
    rt = {"rk": rk.tolist(), "rv": list(range(nr))}
    ls = {"lk": dt.INT64, "lv": dt.INT64}
    rs = {"rk": dt.INT64, "rv": dt.INT64}
    blocks = shard_catalog_blocks(
        {"l": O.pytable_to_block(lt, ls), "r": O.pytable_to_block(rt, rs)}, mesh
    )
    return lt, rt, blocks


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_skew_join_parity(mesh, kind):
    lt, rt, blocks = skewed_tables(mesh)
    plan = P.SkewShuffleJoin(
        kind=kind, probe_keys=["lk"], build_keys=["rk"],
        probe=P.TableScan("l"), build=P.TableScan("r"),
        output_capacity=4096,
    )
    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(shuffle_factor=4.0))
    out, overflows = fn(blocks)
    assert not any(bool(np.asarray(v).max()) for v in overflows.values()), overflows
    got = O.block_to_pytable(collect_result(out))
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(got, want)


def test_skew_join_avoids_shuffle_overflow(mesh):
    """With 60% of rows on one key, a plain hash shuffle with factor ~1
    must overflow one partition; the skew-aware join must NOT (hot rows
    never enter the exchange)."""
    from tiflash_jax.plan.distribute import shuffle_join

    lt, rt, blocks = skewed_tables(mesh, nl=1600)
    plain = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=4096,
    )
    fn = compile_distributed(plain, mesh, cfg=ExchangeConfig(shuffle_factor=1.0))
    _, overflows = fn(blocks)
    assert any(bool(np.asarray(v).max()) for v in overflows.values()), (
        "test premise: plain shuffle must overflow under this skew"
    )

    skew = P.SkewShuffleJoin(
        kind="inner", probe_keys=["lk"], build_keys=["rk"],
        probe=P.TableScan("l"), build=P.TableScan("r"), output_capacity=4096,
    )
    fn2 = compile_distributed(skew, mesh, cfg=ExchangeConfig(shuffle_factor=1.0))
    out, overflows2 = fn2(blocks)
    assert not any(bool(np.asarray(v).max()) for v in overflows2.values()), overflows2
    got = O.block_to_pytable(collect_result(out))
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_detect_hot_keys_finds_heavy_hitter(mesh):
    n = 512
    keys = np.where(np.arange(n) % 2 == 0, 42, np.arange(n) + 1000).astype(np.int64)

    def f(k):
        return detect_hot_keys(k, jnp.ones(n // 8, bool), "d", sample_per_device=64, hot_k=8)

    sharded = jax.device_put(
        jnp.asarray(keys),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("d")),
    )
    hot = jax.jit(
        jax.shard_map(f, mesh=mesh, in_specs=(jax.sharding.PartitionSpec("d"),),
                      out_specs=jax.sharding.PartitionSpec(), check_vma=False)
    )(sharded)
    assert 42 in np.asarray(hot).tolist()


def test_concat_blocks():
    import tiflash_jax.core.dtypes as dtt

    a = O.pytable_to_block({"x": [1, 2]}, {"x": dtt.INT64})
    b = O.pytable_to_block({"x": [3, 4, 5]}, {"x": dtt.INT64}).and_sel(
        jnp.asarray([True, False, True])
    )
    c = concat_blocks(a, b)
    assert O.block_to_pytable(c)["x"] == [1, 2, 3, 5]
