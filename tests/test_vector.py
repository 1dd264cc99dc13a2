"""VECTOR Float32: distance function family + brute-force batch search.

Reference surface: vecL2Distance / vecCosineDistance /
vecNegativeInnerProduct / vecL1Distance / vecL2Norm / vecDims sigs
(/root/reference/dbms/src/Flash/Coprocessor/DAGUtils.cpp:92) and the
vector-search path (VectorSearch/, Storages/DeltaMerge/Index/VectorIndex/)
— here exact brute force (one matrix product) instead of an HNSW index
(ops/vector.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block, column_from_numpy
from tiflash_jax.core.dtypes import TypeKind, Vector
from tiflash_jax.expr.nodes import call, col, lit
from tiflash_jax.expr.compile import evaluate_expr
from tiflash_jax.ops.vector import block_vector_search, vector_search
from tiflash_jax.testing import oracle as O

DIMS = 24
SCHEMA = {
    "v": Vector(DIMS),
    "w": Vector(DIMS, nullable=True),
    "i": dt.INT64,
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(77)
    table = O.random_pytable(rng, 200, SCHEMA)
    # plant an exact duplicate and a zero vector (cosine NULL path)
    table["w"][3] = table["v"][3]
    table["w"][5] = tuple(0.0 for _ in range(DIMS))
    return table, O.pytable_to_block(table, SCHEMA)


def check(expr, data, rel=1e-5):
    table, block = data
    got_col = evaluate_expr(expr, block)
    got = O.block_to_pytable(Block(names=("r",), columns=(got_col,)))["r"]
    want = O.eval_expr_table(expr, table)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            assert g is None and w is None, (i, g, w, expr)
        else:
            assert abs(float(g) - float(w)) <= rel * max(1.0, abs(float(w))), \
                (i, g, w, expr)


QVEC = [0.5 * ((i % 7) - 3) for i in range(DIMS)]

CASES = [
    call("vec_l2_distance", col("v"), col("w")),
    call("vec_l2_distance", col("v"), lit(QVEC)),
    call("vec_l1_distance", col("v"), col("w")),
    call("vec_negative_inner_product", col("v"), lit(QVEC)),
    call("vec_cosine_distance", col("v"), col("w")),  # zero vec -> NULL
    call("vec_l2_norm", col("v")),
    call("vec_dims", col("v")),
]


@pytest.mark.parametrize("expr", CASES, ids=[str(i) for i in range(len(CASES))])
def test_vec_functions(expr, data):
    check(expr, data)


def test_vec_duplicate_row_is_zero(data):
    _, block = data
    c = evaluate_expr(call("vec_l2_distance", col("v"), col("w")), block)
    vals = O.block_to_pytable(Block(names=("r",), columns=(c,)))["r"]
    assert vals[3] == 0.0


def test_vec_dim_mismatch(data):
    _, block = data
    with pytest.raises(ValueError):
        evaluate_expr(call("vec_l2_distance", col("v"), lit([1.0, 2.0])), block)


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "inner_product"])
def test_vector_search_vs_numpy(metric, data):
    table, block = data
    q = np.asarray([QVEC, [0.1] * DIMS, list(reversed(QVEC))], dtype=np.float32)
    k = 7
    dist, idx = vector_search(block["v"], jnp.asarray(q), k, metric=metric)
    dist, idx = np.asarray(dist), np.asarray(idx)
    x = np.asarray([row for row in table["v"]], dtype=np.float32)
    for qi in range(q.shape[0]):
        if metric == "l2":
            ref = np.sqrt(((x - q[qi]) ** 2).sum(axis=1))
        elif metric == "l1":
            ref = np.abs(x - q[qi]).sum(axis=1)
        elif metric == "cosine":
            ref = 1 - (x @ q[qi]) / np.maximum(
                np.linalg.norm(x, axis=1) * np.linalg.norm(q[qi]), 1e-30)
        else:
            ref = -(x @ q[qi])
        order = np.argsort(ref, kind="stable")[:k]
        # same set of neighbours, distances sorted and close
        assert set(idx[qi].tolist()) == set(order.tolist()), metric
        assert np.all(np.diff(dist[qi]) >= -1e-5)
        np.testing.assert_allclose(
            np.sort(dist[qi]), np.sort(ref[order]), rtol=2e-4, atol=2e-4)


def test_vector_search_respects_sel_and_null(data):
    table, block = data
    q = jnp.asarray([QVEC], dtype=jnp.float32)
    # NULL rows in w must never be returned
    nulls = {i for i, v in enumerate(table["w"]) if v is None}
    if nulls:
        _, idx = vector_search(block["w"], q, 10)
        assert not (set(np.asarray(idx)[0].tolist()) & nulls)
    # sel mask: restrict to even rows
    sel = jnp.arange(block.capacity) % 2 == 0
    _, idx = vector_search(block["v"], q, 10, sel=sel)
    assert all(i % 2 == 0 for i in np.asarray(idx)[0].tolist())


def test_ann_through_plan(data):
    """Single-query ANN as plan composition: Projection(distance) + TopN."""
    import tiflash_jax.plan.nodes as P
    from tiflash_jax.plan.compiler import compile_fragment
    from tiflash_jax.ops.sort import SortKey

    table, block = data
    plan = P.TopN(
        [SortKey("d", desc=False)], 5,
        P.Projection({"i": col("i"),
                      "d": call("vec_l2_distance", col("v"), lit(QVEC))},
                     P.TableScan("t")),
    )
    out, ov = compile_fragment(plan)({"t": block})
    assert all(int(np.asarray(v)) == 0 for v in ov.values())
    got = O.block_to_pytable(out)
    x = np.asarray([row for row in table["v"]], dtype=np.float32)
    ref = np.sqrt(((x - np.asarray(QVEC, dtype=np.float32)) ** 2).sum(axis=1))
    want_rows = np.argsort(ref, kind="stable")[:5]
    assert got["i"] == [table["i"][j] for j in want_rows]


def test_vector_block_take_roundtrip(data):
    table, block = data
    out = block.take(jnp.asarray([2, 0, 3], dtype=jnp.int32))
    vals = O.block_to_pytable(out)["v"]
    for got, j in zip(vals, [2, 0, 3]):
        np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                                   np.asarray(table["v"][j], dtype=np.float32))


def test_vector_search_tiled_path_large_n():
    """n past the tile threshold exercises _batched_min_k's two-stage
    selection; exact parity with numpy."""
    rng = np.random.default_rng(123)
    n, d, k = 10_000, 8, 37
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(3, d)).astype(np.float32)
    colv = column_from_numpy([tuple(r) for r in x], Vector(d))
    dist, idx = vector_search(colv, jnp.asarray(q), k, metric="l2")
    dist, idx = np.asarray(dist), np.asarray(idx)
    for qi in range(3):
        ref = np.sqrt(((x - q[qi]) ** 2).sum(axis=1))
        order = np.argpartition(ref, k)[:k]
        assert set(idx[qi].tolist()) == set(order.tolist())
        np.testing.assert_allclose(np.sort(dist[qi]), np.sort(ref[order]),
                                   rtol=2e-4, atol=2e-4)
        assert np.all(np.diff(dist[qi]) >= -1e-5)


@pytest.mark.parametrize("metric", ["l2", "inner_product"])
def test_vector_search_exact_ranking_vs_float64(metric):
    """Rankings equal a float64 reference's: the k returned rows are the k
    best by exact distance, up to ties within 1e-6 relative.  A reduced
    precision product (TF32, the GPU's float32 default) fails this."""
    rng = np.random.default_rng(5)
    n, d, nq, k = 50_000, 128, 8, 100
    # non-negative, uncentred vectors (as many embedding models emit):
    # dense near-ties that a TF32 product reorders
    x = rng.random(size=(n, d)).astype(np.float32)
    q = rng.random(size=(nq, d)).astype(np.float32)
    colv = column_from_numpy([tuple(r) for r in x], Vector(d))
    dist, idx = vector_search(colv, jnp.asarray(q), k, metric=metric)
    dist, idx = np.asarray(dist), np.asarray(idx)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    for qi in range(nq):
        if metric == "l2":
            exact = np.sqrt(((x64 - q64[qi]) ** 2).sum(axis=1))
        else:
            exact = -(x64 @ q64[qi])
        best = np.sort(exact)[:k]
        got = exact[idx[qi]]
        np.testing.assert_allclose(got, best, rtol=1e-6)
        np.testing.assert_allclose(dist[qi], got, rtol=1e-5, atol=1e-5)
