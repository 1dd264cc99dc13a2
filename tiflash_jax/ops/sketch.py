"""Mergeable distinct-count sketch (KMV) — the HLL-family analog.

Role analog: ``AggregateFunctions/AggregateFunctionUniq.h`` (HyperLogLog
with small-set optimization) and ``UniquesHashSet.h``.  HLL's
register-update is a scatter-max on random register ids, which this
engine's scatter-free design avoids.  Its mergeable sketch is
**K minimum values** over 62-bit value
hashes: building it is a tiled bottom-k selection (the same log²W network
as top-N, ``ops/sort.py:top_n``), merging is concat + the same selection,
and both are sort-based — no scatter anywhere.

Estimator: with k-th smallest distinct hash h_k out of hash space H=2^62,
NDV ≈ (k-1) * H / h_k; when fewer than k distinct hashes exist the count
is exact.  Standard error ≈ 1/sqrt(k-2) (~1.6% at k=4096).

The small-set optimization falls out for free: candidates are exact until
k distinct values are seen.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SKETCH_K = 4096
_TILE = 2048
_HASH_SPACE = float(2**62)
_INF = np.int64(2**62)  # above every hash (hashes are masked to 62 bits)


def _dedupe_sorted(arr: jnp.ndarray) -> jnp.ndarray:
    """Ascending array -> duplicates replaced with +inf (order broken;
    caller re-sorts)."""
    dup = jnp.concatenate([
        jnp.zeros(arr.shape[:-1] + (1,), jnp.bool_),
        arr[..., 1:] == arr[..., :-1],
    ], axis=-1)
    return jnp.where(dup, _INF, arr)


def kmv_candidates(hashes: jnp.ndarray, live: jnp.ndarray, k: int = SKETCH_K) -> jnp.ndarray:
    """The k smallest DISTINCT hash values among live rows, ascending,
    padded with +inf.  Exact: a hash in the global bottom-k-distinct is in
    its tile's bottom-k-distinct, so per-tile selection loses nothing."""
    vals = jnp.where(live, hashes, _INF)
    n = vals.shape[0]
    if n > 2 * _TILE and n > k:
        T = -(-n // _TILE)
        pad = T * _TILE - n
        if pad:
            vals = jnp.concatenate([vals, jnp.full((pad,), _INF, jnp.int64)])
        tiles = jax.lax.sort(vals.reshape(T, _TILE), dimension=-1)
        tiles = jax.lax.sort(_dedupe_sorted(tiles), dimension=-1)
        vals = tiles[:, : min(k, _TILE)].reshape(-1)
    cands = jax.lax.sort(vals)
    cands = jax.lax.sort(_dedupe_sorted(cands))
    if cands.shape[0] < k:
        cands = jnp.concatenate(
            [cands, jnp.full((k - cands.shape[0],), _INF, jnp.int64)]
        )
    return cands[:k]


def kmv_estimate(cands: jnp.ndarray) -> jnp.ndarray:
    """NDV estimate (int64) from an ascending candidate array."""
    k = cands.shape[0]
    m = jnp.sum(cands < _INF)
    kth = jnp.maximum(cands[k - 1].astype(jnp.float64), 1.0)
    est = jnp.round((k - 1) * _HASH_SPACE / kth).astype(jnp.int64)
    return jnp.where(m < k, m.astype(jnp.int64), est)


__all__ = ["SKETCH_K", "kmv_candidates", "kmv_estimate"]
