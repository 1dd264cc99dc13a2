"""Brute-force vector search: batch query × column distance matmul + top-k.

Role analog: the reference's vector search path (``VectorSearch/USearch.h``,
``Storages/DeltaMerge/Index/VectorIndex/`` + ``tipb::ANNQueryInfo``) — but
re-designed for a matrix unit: instead of a graph index (HNSW) with
pointer-chasing, exact brute force where the whole scoring phase is ONE
(q, d) x (d, n) matrix product.  It returns exact (not approximate)
neighbours: the product runs at full float32 precision, because a GPU's
default float32 product rounds its inputs to TF32 (10 mantissa bits),
which reorders near neighbours.

Single-query ANN through the plan layer needs no special node:
``Projection(dist=vec_l2_distance(v, [..]))`` + ``TopN(dist, k)`` composes
from existing operators; this module is the batched many-queries form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.block import Block, Column

_METRICS = ("l2", "l1", "cosine", "inner_product")


def vector_search(
    col: Column,
    queries: jnp.ndarray,
    k: int,
    metric: str = "l2",
    sel: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-nearest rows of ``col`` for each query row.

    col      — VECTOR column, data (n, d) float32.
    queries  — (q, d) float32.
    k        — neighbours per query.
    metric   — l2 | l1 | cosine | inner_product (inner_product ranks by
               LARGEST dot product, i.e. negative-inner-product distance).
    sel      — optional (n,) live-row mask (Block.sel); dead/NULL rows
               never match.

    Returns (distances (q, k) float32, indices (q, k) int32), each query's
    neighbours sorted best-first.  l1 falls back to the broadcast form
    (no matmul identity) — fine for moderate n*q.
    """
    if metric not in _METRICS:
        raise ValueError(f"metric must be one of {_METRICS}")
    if not col.dtype.is_vector:
        raise TypeError("vector_search needs a VECTOR column")
    x = col.data.astype(jnp.float32)  # (n, d)
    q = queries.astype(jnp.float32)  # (q, d)
    n = x.shape[0]

    if metric == "l1":
        # (q, n, d) broadcast reduce; no inner-product identity exists
        score = jnp.sum(jnp.abs(q[:, None, :] - x[None, :, :]), axis=-1)
    else:
        dot = jnp.matmul(q, x.T, precision=jax.lax.Precision.HIGHEST)
        if metric == "l2":
            # |x-q|^2 = |q|^2 - 2 q.x + |x|^2  (clamped: rounding can dip
            # slightly negative for near-identical vectors)
            score = jnp.maximum(
                jnp.sum(q * q, axis=1)[:, None]
                - 2.0 * dot
                + jnp.sum(x * x, axis=1)[None, :],
                0.0,
            )
        elif metric == "cosine":
            norms = (
                jnp.sqrt(jnp.sum(q * q, axis=1))[:, None]
                * jnp.sqrt(jnp.sum(x * x, axis=1))[None, :]
            )
            score = 1.0 - dot / jnp.maximum(norms, jnp.float32(1e-30))
        else:  # inner_product
            score = -dot

    dead = None
    if sel is not None:
        dead = ~sel
    if col.validity is not None:
        dead = ~col.validity if dead is None else (dead | ~col.validity)
    if dead is not None:
        score = jnp.where(dead[None, :], jnp.inf, score)

    k = min(k, n)
    dist, idx = _batched_min_k(score, k)
    if metric == "l2":
        dist = jnp.sqrt(dist)
    return dist, idx.astype(jnp.int32)


def _batched_min_k(score: jnp.ndarray, k: int):
    """k smallest per row of (q, n), best-first, by one batched
    ``lax.top_k``: with a batch of query rows a tiled two-stage selection
    (the ``ops/sort.top_n`` trick) re-touches every element anyway."""
    neg_best, idx = jax.lax.top_k(-score, k)
    return -neg_best, idx


def block_vector_search(
    block: Block, column: str, queries: jnp.ndarray, k: int,
    metric: str = "l2",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """`vector_search` honoring the block's lazy selection mask."""
    return vector_search(
        block[column], queries, k, metric=metric, sel=block.sel_mask()
    )


__all__ = ["vector_search", "block_vector_search"]
