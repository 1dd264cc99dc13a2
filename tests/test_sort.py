"""Sort / Top-N / Limit parity tests.

Role analog: ``Flash/tests/gtest_topn_executor.cpp``.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.ops.sort import SortKey, limit_block, sort_block, top_n
from tiflash_jax.testing import oracle as O


SCHEMA = {
    "a": dt.INT64.with_nullable(True),
    "b": dt.Decimal(10, 2),
    "s": dt.STRING,
    "v": dt.INT32,
}


def make(seed=0, n=300):
    rng = np.random.default_rng(seed)
    table = O.random_pytable(rng, n, SCHEMA, int_range=(-50, 50))
    return table, O.pytable_to_block(table, SCHEMA)


@pytest.mark.parametrize(
    "keys",
    [
        [("a", False)],
        [("a", True)],
        [("b", False), ("a", True)],
        [("s", True), ("v", False)],
    ],
)
def test_sort_orders(keys):
    table, block = make()
    sks = [SortKey(n, desc) for n, desc in keys]
    # MySQL: NULLs first asc, last desc
    sks = [SortKey(n, desc, nulls_first=not desc) for n, desc in keys]
    out = sort_block(block, sks)
    got = O.block_to_pytable(out)
    want = O.o_sort(table, keys)
    O.assert_tables_equal(got, want, ordered=True)


def test_topn_fast_path():
    table, block = make(seed=1)
    out = top_n(block, [SortKey("v", desc=True)], 10)
    got = O.block_to_pytable(out)
    want = O.o_sort(table, [("v", True)], limit=10)
    # ties make exact row sets ambiguous; compare sorted key column only
    assert sorted(got["v"]) == sorted(want["v"])


def test_topn_general():
    table, block = make(seed=2)
    out = top_n(block, [SortKey("a", nulls_first=True), SortKey("v", desc=True)], 17)
    got = O.block_to_pytable(out)
    want = O.o_sort(table, [("a", False), ("v", True)], limit=17)
    O.assert_tables_equal(got, want, ordered=True)


def test_topn_limit_larger_than_rows():
    table, block = make(seed=3, n=8)
    out = top_n(block, [SortKey("v")], 100)
    got = O.block_to_pytable(out)
    want = O.o_sort(table, [("v", False)], limit=100)
    assert got["v"] == want["v"]


def test_limit():
    table, block = make(seed=4)
    out = limit_block(block, 25)
    got = O.block_to_pytable(out)
    # limit keeps the first 25 live rows in input order
    assert got["v"] == table["v"][:25]


def test_sort_after_filter_mask():
    import jax.numpy as jnp

    table, block = make(seed=5)
    mask = np.array(table["v"]) > 0
    block = block.and_sel(jnp.asarray(mask))
    out = sort_block(block, [SortKey("v")])
    got = O.block_to_pytable(out)
    ftable = {k: [x for x, m in zip(vs, mask) if m] for k, vs in table.items()}
    want = O.o_sort(ftable, [("v", False)])
    O.assert_tables_equal(got, want, ordered=True)


def test_top_n_tiled_large_input():
    """Large-n tiled top-N path (per-tile sort + candidate merge) parity."""
    import jax.numpy as jnp

    from tiflash_jax.ops.sort import SortKey, top_n

    rng = np.random.default_rng(33)
    schema = {"a": dt.INT64.with_nullable(True), "b": dt.FLOAT64,
              "v": dt.INT64}
    n = 100_000
    table = O.random_pytable(rng, n, schema, int_range=(0, 500))
    block = O.pytable_to_block(table, schema)
    mask = np.asarray(rng.random(n) < 0.8)
    block = block.and_sel(jnp.asarray(mask))
    ftable = {k: [x for x, m in zip(v, mask) if m] for k, v in table.items()}
    got_b = top_n(block, [SortKey("a", desc=True, nulls_first=False),
                          SortKey("b")], 150)
    got = O.block_to_pytable(got_b)
    want = O.o_sort(ftable, [("a", True), ("b", False)], limit=150)
    O.assert_tables_equal(got, want, ordered=True)


def test_top_n_tiled_more_limit_than_live():
    """Tiled path when the limit exceeds the live row count."""
    import jax.numpy as jnp

    from tiflash_jax.ops.sort import SortKey, top_n

    rng = np.random.default_rng(34)
    schema = {"a": dt.INT64, "v": dt.INT64}
    n = 20_000
    table = O.random_pytable(rng, n, schema, null_prob=0)
    block = O.pytable_to_block(table, schema)
    mask = np.asarray(rng.random(n) < 0.002)  # ~40 live rows
    block = block.and_sel(jnp.asarray(mask))
    got_b = top_n(block, [SortKey("a")], 500)
    ftable = {k: [x for x, m in zip(v, mask) if m] for k, v in table.items()}
    got = O.block_to_pytable(got_b)
    want = O.o_sort(ftable, [("a", False)], limit=500)
    O.assert_tables_equal(got, want, ordered=True)


def test_desc_sort_places_nulls_last_by_default():
    """MySQL/TiDB ORDER BY x DESC: NULL is smallest -> sorts LAST.
    Found by the plan fuzzer via a full-outer-join non-matched tail
    (engine used nulls-first regardless of direction)."""
    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.ops.sort import SortKey, sort_block, top_n
    from tiflash_jax.testing import oracle as O

    pt = {"x": [3, None, 1, None, 2], "id": [0, 1, 2, 3, 4]}
    sch = {"x": dt.INT64.with_nullable(True), "id": dt.INT64}
    blk = O.pytable_to_block(pt, sch)
    got = O.block_to_pytable(sort_block(blk, [SortKey("x", desc=True)]).compact())
    assert got["x"] == [3, 2, 1, None, None]
    got_asc = O.block_to_pytable(sort_block(blk, [SortKey("x")]).compact())
    assert got_asc["x"] == [None, None, 1, 2, 3]
    # top_n general path honors it too
    top = O.block_to_pytable(top_n(blk, [SortKey("x", desc=True)], 3).compact())
    assert top["x"] == [3, 2, 1]
    # explicit override still wins
    got_o = O.block_to_pytable(
        sort_block(blk, [SortKey("x", desc=True, nulls_first=True)]).compact())
    assert got_o["x"] == [None, None, 3, 2, 1]


def test_topk_tiled_fast_path_matches_full_sort():
    """The per-tile lax.top_k cascade (single-key rank pack) must match
    the stable full-sort order exactly — ties, NULL placement, dead
    rows, and >2-level cascades included."""
    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.core.block import Block, column_from_numpy
    from tiflash_jax.ops.sort import SortKey, sort_block, top_n

    rng = np.random.default_rng(11)
    n = 40_000  # > 4 * TILE -> tiled path; cascade reduces 40000 -> ~1900

    # case A: int64 key, no validity, no sel (pure-rank path)
    vals = rng.integers(-50, 50, n)  # heavy ties
    blk = Block.from_dict({
        "k": column_from_numpy(vals, dt.INT64),
        "v": column_from_numpy(np.arange(n), dt.INT64),
    })
    for desc in (False, True):
        keys = [SortKey("k", desc=desc)]
        got = top_n(blk, keys, 97).compact().to_pylists()
        ref = sort_block(blk, keys).compact().to_pylists()
        assert got["k"] == ref["k"][:97]
        assert got["v"] == ref["v"][:97]

    # case B: int32 key with NULLs and a selection mask (packed rank)
    vals32 = rng.integers(-5, 5, n)
    nulls = rng.random(n) < 0.2
    sel = rng.random(n) < 0.7
    import jax.numpy as jnp

    blk2 = Block.from_dict({
        "k": column_from_numpy(
            [0 if m else int(v) for v, m in zip(vals32, nulls)],
            dt.INT32.with_nullable(True),
            validity=[not m for m in nulls]),
        "v": column_from_numpy(np.arange(n), dt.INT64),
    }).with_sel(jnp.asarray(sel))
    for desc in (False, True):
        for nf in (None, True, False):
            keys = [SortKey("k", desc=desc, nulls_first=nf)]
            got = top_n(blk2, keys, 61).compact().to_pylists()
            ref = sort_block(blk2, keys).compact().to_pylists()
            assert got["k"] == ref["k"][:61], (desc, nf)
            assert got["v"] == ref["v"][:61], (desc, nf)
