"""Hash-aggregation parity tests (engine vs oracle).

Role analog: ``Flash/tests/gtest_aggregation_executor.cpp`` — randomized
inputs across key-type shapes, both aggregation methods exercised.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.ops.aggregate import AggDesc, hash_aggregate, aggregate_sort, aggregate_direct, pack_keys_direct
from tiflash_jax.testing import oracle as O


def run_agg(schema, keys, aggs, n=500, null_prob=0.15, seed=0, force=None, sel_expr=None):
    rng = np.random.default_rng(seed)
    table = O.random_pytable(rng, n, schema, null_prob=null_prob)
    block = O.pytable_to_block(table, schema)
    if force == "sort":
        res = aggregate_sort(block, keys, aggs, num_slots=n)
    elif force == "direct":
        packed = pack_keys_direct([block[k] for k in keys])
        assert packed is not None
        res = aggregate_direct(block, keys, aggs, packed)
    else:
        res = hash_aggregate(block, keys, aggs)
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(table, keys, [(a.func, a.arg, a.name) for a in aggs])
    O.assert_tables_equal(got, want, approx_cols=[a.name for a in aggs
                                                 if a.func in ("sum", "avg")
                                                 and schema.get(a.arg, dt.INT64).is_float])
    assert int(res.num_groups) == len(want[keys[0]] if keys else [0])
    assert not bool(res.overflow)


AGGS = [
    AggDesc("sum", "v", "sum_v"),
    AggDesc("count", None, "cnt"),
    AggDesc("count", "v", "cnt_v"),
    AggDesc("min", "v", "min_v"),
    AggDesc("max", "v", "max_v"),
    AggDesc("avg", "v", "avg_v"),
]


def test_agg_int_key_sort_path():
    run_agg({"k": dt.INT32, "v": dt.INT64.with_nullable(True)}, ["k"], AGGS, force="sort")


def test_agg_string_key_direct_path():
    run_agg({"k": dt.STRING, "v": dt.Decimal(12, 2, nullable=True)}, ["k"], AGGS, force="direct")


def test_agg_nullable_string_key():
    run_agg({"k": dt.STRING.with_nullable(True), "v": dt.INT64}, ["k"], AGGS)


def test_agg_multi_key_mixed():
    run_agg(
        {"k1": dt.STRING, "k2": dt.BOOL.with_nullable(True), "v": dt.Decimal(10, 2)},
        ["k1", "k2"],
        AGGS,
        force="direct",
    )


def test_agg_multi_key_sort():
    run_agg(
        {"k1": dt.INT64.with_nullable(True), "k2": dt.INT32, "v": dt.FLOAT64.with_nullable(True)},
        ["k1", "k2"],
        [AggDesc("sum", "v", "s"), AggDesc("count", None, "c"),
         AggDesc("min", "v", "mn"), AggDesc("max", "v", "mx")],
        force="sort",
    )


def test_agg_decimal_avg_scale():
    # avg over decimal(10,2) must produce scale 6 with half-up rounding
    run_agg({"k": dt.INT8, "v": dt.Decimal(10, 2)}, ["k"], [AggDesc("avg", "v", "a")])


def test_agg_scalar_no_keys():
    run_agg({"v": dt.INT64.with_nullable(True)}, [], AGGS[:4])


def test_agg_with_selection_mask():
    """Aggregation must honor a pre-existing filter mask (lazy filters)."""
    schema = {"k": dt.INT8, "v": dt.INT64}
    rng = np.random.default_rng(3)
    table = O.random_pytable(rng, 400, schema, null_prob=0)
    block = O.pytable_to_block(table, schema)
    import jax.numpy as jnp

    mask = jnp.asarray(np.array(table["v"]) % 2 == 0)
    block = block.and_sel(mask)
    res = hash_aggregate(block, ["k"], [AggDesc("sum", "v", "s"), AggDesc("count", None, "c")])
    got = O.block_to_pytable(res.block)
    ftable = {k: [v for v, m in zip(vs, np.asarray(mask)) if m] for k, vs in table.items()}
    want = O.o_aggregate(ftable, ["k"], [("sum", "v", "s"), ("count", None, "c")])
    O.assert_tables_equal(got, want)


def test_agg_all_rows_filtered_out():
    schema = {"k": dt.INT8, "v": dt.INT64}
    rng = np.random.default_rng(4)
    table = O.random_pytable(rng, 64, schema, null_prob=0)
    block = O.pytable_to_block(table, schema)
    import jax.numpy as jnp

    block = block.and_sel(jnp.zeros(64, dtype=bool))
    res = hash_aggregate(block, ["k"], [AggDesc("sum", "v", "s")])
    assert int(res.num_groups) == 0
    got = O.block_to_pytable(res.block)
    assert got["s"] == []


def test_agg_under_jit():
    """The whole aggregation must be jittable (block pytree in/out)."""
    import jax

    schema = {"k": dt.INT16, "v": dt.Decimal(12, 2)}
    rng = np.random.default_rng(5)
    table = O.random_pytable(rng, 256, schema, null_prob=0)
    block = O.pytable_to_block(table, schema)
    aggs = [AggDesc("sum", "v", "s"), AggDesc("count", None, "c")]

    @jax.jit
    def run(b):
        r = hash_aggregate(b, ["k"], aggs, num_slots=256)
        return r.block, r.num_groups

    out, ng = run(block)
    want = O.o_aggregate(table, ["k"], [("sum", "v", "s"), ("count", None, "c")])
    O.assert_tables_equal(O.block_to_pytable(out), want)
    assert int(ng) == len(want["k"])


def _direct_block(rng, domain, n):
    """A block whose string key takes every one of ``domain`` values, with
    a nullable decimal and int64 values near +-2**52."""
    from tiflash_jax.core.block import Block, column_from_numpy

    keys = [f"k{i:05d}" for i in range(domain)]
    k = keys + [keys[i] for i in rng.integers(0, domain, n - domain)]
    v = rng.integers(-500, 500, n)
    v_ok = rng.random(n) > 0.15
    w = rng.integers(-(2**52), 2**52, n)
    block = Block.from_dict({
        "k": column_from_numpy(k, dt.STRING),
        "v": column_from_numpy(v, dt.Decimal(12, 2, nullable=True),
                               validity=v_ok),
        "w": column_from_numpy(w, dt.INT64),
    })
    return O.block_to_pytable(block), block


@pytest.mark.parametrize("domain", [65, 256, 4096])
def test_direct_segment_path_parity(domain):
    """Direct method above the masked limit (the segment path) vs oracle:
    sums/counts/avg over decimal + nullable columns and int64 values near
    +-2**52, with a selection mask."""
    import jax.numpy as jnp
    from tiflash_jax.ops.aggregate import MASKED_DOMAIN_LIMIT

    rng = np.random.default_rng(9)
    n = 3 * domain
    table, block = _direct_block(rng, domain, n)
    mask = np.asarray(rng.random(n) < 0.7)
    block = block.and_sel(jnp.asarray(mask))
    aggs = [
        AggDesc("sum", "v", "sv"),
        AggDesc("sum", "w", "sw"),
        AggDesc("count", None, "c"),
        AggDesc("count", "v", "cv"),
        AggDesc("avg", "v", "av"),
    ]
    packed = pack_keys_direct([block["k"]])
    assert packed[1] == domain > MASKED_DOMAIN_LIMIT
    res = aggregate_direct(block, ["k"], aggs, packed)
    got = O.block_to_pytable(res.block)
    ftable = {k: [x for x, m in zip(v, mask) if m] for k, v in table.items()}
    want = O.o_aggregate(ftable, ["k"], [(a.func, a.arg, a.name) for a in aggs])
    O.assert_tables_equal(got, want)


@pytest.mark.parametrize("domain", [65, 256, 4096])
def test_direct_segment_path_exact_large_values(domain):
    """Segment-path sums are exact int64 for negatives and magnitudes near
    2**52, in every slot of the domain."""
    import jax.numpy as jnp

    rng = np.random.default_rng(10)
    n = 8 * domain
    _, block = _direct_block(rng, domain, n)
    res = aggregate_direct(block, ["k"], [AggDesc("sum", "w", "s"),
                                          AggDesc("count", None, "c")],
                           pack_keys_direct([block["k"]]))
    slots = np.asarray(block["k"].data)
    w = np.asarray(block["w"].data)
    want_s = [sum(int(x) for x in w[slots == s]) for s in range(domain)]
    want_c = [int((slots == s).sum()) for s in range(domain)]
    assert np.asarray(res.block["s"].data).tolist() == want_s
    assert np.asarray(res.block["c"].data).tolist() == want_c
    assert int(res.num_groups) == domain


def test_count_distinct_and_filter_combinator():
    """count_distinct (sort + direct methods) and the -If filter."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    schema = {
        "k": dt.STRING,
        "v": dt.INT32.with_nullable(True),
        "flag": dt.BOOL.with_nullable(True),
    }
    table = O.random_pytable(rng, 600, schema, int_range=(0, 8))
    block = O.pytable_to_block(table, schema)
    aggs = [
        AggDesc("count_distinct", "v", "cd"),
        AggDesc("sum", "v", "s_if", filter_col="flag"),
        AggDesc("count", None, "c_if", filter_col="flag"),
        AggDesc("min", "v", "mn_if", filter_col="flag"),
    ]
    res = hash_aggregate(block, ["k"], aggs)
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(
        table, ["k"], [(a.func, a.arg, a.name, a.filter_col) for a in aggs]
    )
    O.assert_tables_equal(got, want)
    # sort method too
    res2 = aggregate_sort(block, ["k"], aggs, num_slots=600)
    got2 = O.block_to_pytable(res2.block)
    O.assert_tables_equal(got2, want)


def test_count_distinct_distributed():
    import jax
    from jax.sharding import Mesh

    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.distribute import split_aggregation
    from tiflash_jax.runtime.executor import run_query

    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    rng = np.random.default_rng(13)
    schema = {"k": dt.INT32, "v": dt.INT64.with_nullable(True)}
    table = O.random_pytable(rng, 640, schema, int_range=(0, 15))
    blocks = {"t": O.pytable_to_block(table, schema)}
    aggs = [AggDesc("count_distinct", "v", "cd"), AggDesc("count", None, "c")]
    plan = split_aggregation(["k"], aggs, P.TableScan("t"))
    out, _ = run_query(plan, blocks, mesh=mesh)
    got = O.block_to_pytable(out)
    want = O.o_aggregate(table, ["k"],
                         [("count_distinct", "v", "cd"), ("count", None, "c")])
    O.assert_tables_equal(got, want)


def test_quantile_aggregate():
    """Exact per-group quantile: element at floor(q*(n-1)) of sorted args."""
    rng = np.random.default_rng(30)
    schema = {"k": dt.INT8, "v": dt.INT32.with_nullable(True)}
    table = O.random_pytable(rng, 400, schema, int_range=(-100, 100))
    block = O.pytable_to_block(table, schema)
    for q in (0.0, 0.5, 0.9, 1.0):
        res = hash_aggregate(
            block, ["k"], [AggDesc("quantile", "v", "qv", param=q),
                           AggDesc("count", "v", "c")]
        )
        got = O.block_to_pytable(res.block)
        # python reference
        import math as m
        want_map = {}
        for kk in set(table["k"]):
            xs = sorted(v for k2, v in zip(table["k"], table["v"])
                        if k2 == kk and v is not None)
            want_map[kk] = xs[int(m.floor(q * (len(xs) - 1)))] if xs else None
        for kk, qv in zip(got["k"], got["qv"]):
            assert qv == want_map[kk], (q, kk, qv, want_map[kk])


def test_agg_direct_mid_domain_segment_path():
    """Domain in (64, 4096]: exercises the segment fallback (CPU) and the
    kernel path boundary."""
    rng = np.random.default_rng(31)
    pool = [f"k{i:03d}" for i in range(150)]
    schema = {"k": dt.STRING, "v": dt.INT64}
    table = O.random_pytable(rng, 800, schema, null_prob=0, str_pool=pool)
    block = O.pytable_to_block(table, schema)
    res = hash_aggregate(block, ["k"], [AggDesc("sum", "v", "s"),
                                        AggDesc("avg", "v", "a"),
                                        AggDesc("min", "v", "mn")])
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(table, ["k"],
                         [("sum", "v", "s"), ("avg", "v", "a"), ("min", "v", "mn")])
    O.assert_tables_equal(got, want)


def test_first_any_value():
    rng = np.random.default_rng(40)
    schema = {"k": dt.STRING, "v": dt.INT64.with_nullable(True), "s": dt.STRING}
    table = O.random_pytable(rng, 300, schema, int_range=(0, 50))
    block = O.pytable_to_block(table, schema)
    aggs = [AggDesc("first", "v", "fv"), AggDesc("first", "s", "fs")]
    for force in ("direct", "sort"):
        if force == "direct":
            packed = pack_keys_direct([block["k"]])
            res = aggregate_direct(block, ["k"], aggs, packed)
        else:
            res = aggregate_sort(block, ["k"], aggs, num_slots=300)
        got = O.block_to_pytable(res.block)
        want = O.o_aggregate(table, ["k"], [(a.func, a.arg, a.name) for a in aggs])
        # 'first' in sort order may differ from input order for the sort
        # method; only the direct/masked method guarantees input order
        if force == "direct":
            O.assert_tables_equal(got, want)
        else:
            assert sorted(got["k"]) == sorted(want["k"])


def test_distinct_shape_no_aggs():
    """SELECT DISTINCT == Aggregation(keys, []) — both methods."""
    rng = np.random.default_rng(50)
    schema = {"a": dt.STRING, "b": dt.INT32.with_nullable(True)}
    table = O.random_pytable(rng, 300, schema, int_range=(0, 6))
    block = O.pytable_to_block(table, schema)
    res = hash_aggregate(block, ["a", "b"], [])
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(table, ["a", "b"], [])
    O.assert_tables_equal(got, want)
    res2 = aggregate_sort(block, ["a", "b"], [], num_slots=300)
    got2 = O.block_to_pytable(res2.block)
    O.assert_tables_equal(got2, want)


# ---------------------------------------------------------------------------
# StreamAgg (clustered input, no sort) — tipb StreamAgg analog
# ---------------------------------------------------------------------------

def run_stream(schema, keys, aggs, n=500, null_prob=0.15, seed=3, sel_frac=None):
    """Cluster random data host-side, optionally kill rows via sel, then
    compare aggregate_stream against the oracle on the live subset."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from tiflash_jax.ops.aggregate import aggregate_stream

    rng = np.random.default_rng(seed)
    table = O.random_pytable(rng, n, schema, null_prob=null_prob)

    def keyval(i):
        out = []
        for k in keys:
            v = table[k][i]
            out.append((v is None, v if v is not None else 0))
        return tuple(out)

    order = sorted(range(n), key=keyval)
    table = {c: [table[c][i] for i in order] for c in table}
    block = O.pytable_to_block(table, schema)
    block = _dc.replace(block, clustered_by=tuple(keys))
    if sel_frac is not None:
        sel_np = rng.random(n) < sel_frac
        block = block.and_sel(jnp.asarray(sel_np))
        table = {c: [v for v, s in zip(table[c], sel_np) if s] for c in table}
    res = aggregate_stream(block, keys, aggs, num_slots=n)
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(
        table, keys, [(a.func, a.arg, a.name, a.filter_col) for a in aggs]
    )
    O.assert_tables_equal(
        got,
        want,
        approx_cols=[a.name for a in aggs
                     if a.func in ("sum", "avg")
                     and schema.get(a.arg, dt.INT64).is_float],
    )
    assert int(res.num_groups) == len(want[keys[0]])
    assert not bool(res.overflow)


def test_stream_agg_int_key():
    run_stream({"k": dt.INT32, "v": dt.INT64.with_nullable(True)}, ["k"], AGGS)


def test_stream_agg_dead_rows_interspersed():
    """Filtered rows stay in place; groups that lose every row vanish."""
    run_stream({"k": dt.INT32, "v": dt.INT64.with_nullable(True)}, ["k"], AGGS,
               sel_frac=0.55, seed=11)


def test_stream_agg_multi_key_nullable():
    run_stream(
        {"k1": dt.INT64.with_nullable(True), "k2": dt.STRING,
         "v": dt.FLOAT64.with_nullable(True)},
        ["k1", "k2"], AGGS, sel_frac=0.7, seed=12,
    )


def test_stream_agg_distinct_and_filter():
    aggs = [
        AggDesc("count_distinct", "v", "cd"),
        AggDesc("sum", "v", "s", filter_col="f"),
    ]
    run_stream(
        {"k": dt.INT32, "v": dt.INT32.with_nullable(True), "f": dt.BOOL},
        ["k"], aggs, sel_frac=0.8, seed=13,
    )


def test_stream_agg_dispatch_via_clustered_by():
    """hash_aggregate picks StreamAgg when keys match the clustering."""
    import dataclasses as _dc

    from tiflash_jax.ops import aggregate as agg_mod

    rng = np.random.default_rng(14)
    schema = {"k": dt.INT64, "v": dt.INT64}
    table = O.random_pytable(rng, 200, schema, null_prob=0.0)
    order = sorted(range(200), key=lambda i: table["k"][i])
    table = {c: [table[c][i] for i in order] for c in table}
    block = O.pytable_to_block(table, schema)
    block = _dc.replace(block, clustered_by=("k", "v"))
    called = {}
    orig = agg_mod.aggregate_stream

    def spy(*a, **kw):
        called["yes"] = True
        return orig(*a, **kw)

    agg_mod.aggregate_stream = spy
    try:
        res = agg_mod.hash_aggregate(block, ["k"], [AggDesc("sum", "v", "s")])
    finally:
        agg_mod.aggregate_stream = orig
    assert called.get("yes")
    want = O.o_aggregate(table, ["k"], [("sum", "v", "s")])
    O.assert_tables_equal(O.block_to_pytable(res.block), want)


def test_clustering_metadata_propagation():
    """Block ops preserve/invalidate clustered_by correctly."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from tiflash_jax.core.block import Block, Column

    b = Block.from_dict({
        "a": Column(jnp.arange(6, dtype=jnp.int64), None, dt.INT64),
        "b": Column(jnp.arange(6, dtype=jnp.int64), None, dt.INT64),
        "c": Column(jnp.arange(6, dtype=jnp.int64), None, dt.INT64),
    })
    b = _dc.replace(b, clustered_by=("a", "b"))
    assert b.and_sel(jnp.arange(6) < 3).clustered_by == ("a", "b")
    assert b.select(["a", "c"]).clustered_by == ("a",)
    assert b.select(["b", "c"]).clustered_by == ()
    assert b.with_column("c", b["a"]).clustered_by == ("a", "b")
    assert b.with_column("a", b["c"]).clustered_by == ()
    assert b.with_column("b", b["c"]).clustered_by == ("a",)
    assert b.take(jnp.arange(6)).clustered_by == ()
    assert b.and_sel(jnp.arange(6) % 2 == 0).compact().clustered_by == ("a", "b")


# ---------------------------------------------------------------------------
# group_concat (sort method + host-side decode)
# ---------------------------------------------------------------------------

def run_group_concat(n=200, seed=21, null_prob=0.2, param=None, sep=",",
                     sel_frac=None, distinct=False, use_filter=False):
    import jax.numpy as jnp

    schema = {"k": dt.INT32, "s": dt.STRING.with_nullable(True),
              "v": dt.INT64.with_nullable(True),
              "f": dt.BOOL}
    rng = np.random.default_rng(seed)
    table = O.random_pytable(rng, n, schema, null_prob=null_prob, int_range=(0, 8))
    block = O.pytable_to_block(table, schema)
    if sel_frac is not None:
        sel_np = rng.random(n) < sel_frac
        block = block.and_sel(jnp.asarray(sel_np))
        table = {c: [v for v, s_ in zip(table[c], sel_np) if s_] for c in table}
    fcol = "f" if use_filter else None
    aggs = [
        AggDesc("group_concat", "s", "gc", filter_col=fcol, param=param,
                separator=sep, distinct=distinct),
        AggDesc("sum", "v", "sv"),
    ]
    res = hash_aggregate(block, ["k"], aggs)
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(
        table, ["k"],
        [("group_concat", "s", "gc", fcol, param, sep, distinct),
         ("sum", "v", "sv")],
    )
    O.assert_tables_equal(got, want)


def test_group_concat_basic():
    run_group_concat()


def test_group_concat_truncation_and_separator():
    run_group_concat(param=3, sep="|", seed=22)


def test_group_concat_with_dead_rows():
    run_group_concat(sel_frac=0.6, seed=23)


def test_group_concat_distinct():
    run_group_concat(distinct=True, seed=25)


def test_group_concat_distinct_truncation():
    run_group_concat(distinct=True, param=2, seed=26)


def test_group_concat_if_filter():
    run_group_concat(use_filter=True, seed=27)


def test_group_concat_distinct_if_filter_dead_rows():
    run_group_concat(distinct=True, use_filter=True, sel_frac=0.7, seed=28)


def test_group_concat_non_nullable_distinct():
    run_group_concat(distinct=True, null_prob=0.0, seed=29)


def test_group_concat_all_null_group_is_null():
    import jax.numpy as jnp

    from tiflash_jax.core.block import Block, Column

    b = Block.from_dict({
        "k": Column(jnp.asarray([0, 0, 1, 1], dtype=jnp.int64), None, dt.INT64),
        "s": Column(jnp.asarray([0, 1, 0, 0], dtype=jnp.int32),
                    jnp.asarray([True, True, False, False]),
                    dt.STRING.with_nullable(True), ("a", "b")),
    })
    res = hash_aggregate(b, ["k"], [AggDesc("group_concat", "s", "gc")])
    got = O.block_to_pytable(res.block)
    assert got["gc"] == ["a,b", None]


def test_group_concat_through_topn():
    """gc columns survive a downstream TopN permute (2-D Block.take)."""
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.compiler import compile_fragment
    from tiflash_jax.ops.sort import SortKey
    from tiflash_jax.storage.catalog import Catalog

    schema = {"k": dt.INT32, "s": dt.STRING, "v": dt.INT64}
    rng = np.random.default_rng(24)
    table = O.random_pytable(rng, 120, schema, null_prob=0.0, int_range=(0, 9))
    cat = Catalog()
    block = O.pytable_to_block(table, schema)
    cat.register("t", dict(zip(block.names, block.columns)))
    plan = P.TopN(
        [SortKey("sv", desc=True)], 5,
        P.Aggregation(
            keys=["k"],
            aggs=[AggDesc("group_concat", "s", "gc"), AggDesc("sum", "v", "sv")],
            child=P.TableScan("t"),
        ),
    )
    out, ov = compile_fragment(plan)(cat.blocks())
    assert all(not bool(x) for x in ov.values())
    got = O.block_to_pytable(out)
    want = O.o_aggregate(table, ["k"], [
        ("group_concat", "s", "gc"), ("sum", "v", "sv")])
    order = sorted(range(len(want["sv"])), key=lambda i: -want["sv"][i])[:5]
    assert got["sv"] == [want["sv"][i] for i in order]
    assert got["gc"] == [want["gc"][i] for i in order]


BIT_AGGS = [
    AggDesc("bit_and", "v", "ba"),
    AggDesc("bit_or", "v", "bo"),
    AggDesc("bit_xor", "v", "bx"),
]


def test_bit_aggs_sort_path():
    """BIT_AND/OR/XOR via the sorted segmented scan (reference
    AggregateFunctionBitwise.h)."""
    run_agg({"k": dt.INT64, "v": dt.INT64.with_nullable(True)}, ["k"],
            BIT_AGGS, force="sort", seed=21)


def test_bit_aggs_masked_tiny_domain():
    run_agg({"k": dt.INT8, "v": dt.INT64.with_nullable(True)}, ["k"],
            BIT_AGGS + [AggDesc("sum", "v", "s")], seed=22, n=300)


def test_bit_aggs_dispatch_large_direct_domain():
    # packable key domain > MASKED_DOMAIN_LIMIT must re-route to sort
    run_agg({"k": dt.INT32, "v": dt.INT64}, ["k"], BIT_AGGS, seed=23,
            null_prob=0, n=800)


def test_bit_aggs_scalar():
    from tiflash_jax.ops.aggregate import aggregate_scalar

    rng = np.random.default_rng(31)
    schema = {"v": dt.INT64.with_nullable(True)}
    table = O.random_pytable(rng, 400, schema)
    block = O.pytable_to_block(table, schema)
    out = O.block_to_pytable(aggregate_scalar(block, BIT_AGGS))
    want = O.o_aggregate(table, [], [(a.func, a.arg, a.name) for a in BIT_AGGS])
    O.assert_tables_equal(out, want)


def test_bit_aggs_negative_values_u64():
    """Negative ints reduce as their two's-complement u64 bit patterns."""
    table = {"k": [1, 1, 2], "v": [-1, 5, -2]}
    block = O.pytable_to_block(table, {"k": dt.INT64, "v": dt.INT64})
    res = hash_aggregate(block, ["k"], BIT_AGGS)
    got = O.block_to_pytable(res.block)
    want = O.o_aggregate(table, ["k"],
                         [(a.func, a.arg, a.name) for a in BIT_AGGS])
    O.assert_tables_equal(got, want)
    i = got["k"].index(1)
    assert got["ba"][i] == 5  # -1 & 5
    assert got["bo"][i] == (1 << 64) - 1  # -1 | 5 == -1 as u64 (all ones)
    j = got["k"].index(2)
    assert got["ba"][j] == (1 << 64) - 2


def test_bit_aggs_all_null_group_identity():
    table = {"k": [1, 1, 2], "v": [None, None, 3]}
    block = O.pytable_to_block(table,
                               {"k": dt.INT64,
                                "v": dt.INT64.with_nullable(True)})
    res = hash_aggregate(block, ["k"], BIT_AGGS)
    got = O.block_to_pytable(res.block)
    i = got["k"].index(1)
    assert got["ba"][i] == (1 << 64) - 1  # identity, not NULL
    assert got["bo"][i] == 0 and got["bx"][i] == 0


def test_bit_aggs_distributed():
    import jax
    from jax.sharding import Mesh

    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.distribute import split_aggregation
    from tiflash_jax.runtime.executor import run_query

    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    rng = np.random.default_rng(41)
    schema = {"k": dt.INT64, "v": dt.INT64.with_nullable(True)}
    table = O.random_pytable(rng, 640, schema, int_range=(0, 6))
    blocks = {"t": O.pytable_to_block(table, schema)}
    plan = split_aggregation(["k"], BIT_AGGS, P.TableScan("t"))
    out, _ = run_query(plan, blocks, mesh=mesh)
    got = O.block_to_pytable(out)
    want = O.o_aggregate(table, ["k"],
                         [(a.func, a.arg, a.name) for a in BIT_AGGS])
    O.assert_tables_equal(got, want)
