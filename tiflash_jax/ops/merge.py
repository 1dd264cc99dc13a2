"""Packed-sort merge primitives — the engine's fast paths for
"positions in a sorted array" problems.

Cost model (from the accelerator the engine was first built for; not yet
re-measured on the GPU, ROADMAP queue 1): a single-operand int64
``lax.sort`` is far cheaper than multi-operand sorts, and
``jnp.searchsorted(method="sort")`` pays a multi-operand sort PLUS an
un-sort.  Packing (value << 31 | index) into ONE int64 makes both the
merge and the route-back single-operand sorts:

- ``flagged_positions``: dense table of flagged row indices (group ends,
  compactions) — one 1-op sort + static slice.
- ``probe_ranges_fast``: lo AND hi probe ranges from one merged 1-op
  sort + one 2-op route-back sort (measured 21ms vs 83ms for two
  searchsorted calls at 1.5M keys / 2.1M queries), with a runtime
  ``lax.cond`` fallback to searchsorted when the live key span does not
  fit the 31-bit packing budget.

Role analog: the probe side of ``Interpreters/Join.cpp:1977`` /
hash-table lookup; here lookups are merge positions in sorted key space.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_IDX_BITS = 31
_IDX_MASK = np.int64((1 << _IDX_BITS) - 1)
_DEAD_BIT = np.int64(1) << 62


def flagged_positions(flags: jnp.ndarray, num_out: int) -> jnp.ndarray:
    """Indices of set flags, in order, as a dense (num_out,) int32 table
    padded with -1.  One single-operand sort + static slice."""
    n = flags.shape[0]
    idx = jnp.arange(n, dtype=jnp.int64)
    packed = jnp.where(flags, idx, idx | _DEAD_BIT)
    s = jax.lax.sort(packed)
    k = min(num_out, n)
    head = s[:k]
    out = jnp.where(head < _DEAD_BIT, head, jnp.int64(-1)).astype(jnp.int32)
    if num_out > n:
        out = jnp.concatenate(
            [out, jnp.full(num_out - n, -1, dtype=jnp.int32)])
    return out


def _merged_lo_hi(kv: jnp.ndarray, qv: jnp.ndarray,
                  nk: int, nq: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """lo/hi of each query value among key values; all values must be
    non-negative and < 2^31, with dead keys already mapped ABOVE every
    query value.  Keys tie-break before queries (hi semantics)."""
    m = nk + nq
    vals = jnp.concatenate([kv, qv])
    idx = jnp.arange(m, dtype=jnp.int64)
    packed = (vals << _IDX_BITS) | idx
    s = jax.lax.sort(packed)
    sidx = s & _IDX_MASK
    sval = s >> _IDX_BITS
    is_q = sidx >= nk
    cnt_q_excl = jnp.cumsum(is_q.astype(jnp.int32)) - is_q.astype(jnp.int32)
    pos = jnp.arange(m, dtype=jnp.int32)
    hi_at = pos - cnt_q_excl                       # #keys strictly before p
    b = jnp.concatenate([jnp.ones(1, bool), sval[1:] != sval[:-1]])
    lo_at = jax.lax.cummax(jnp.where(b, hi_at, jnp.int32(-1)))
    # route query results back to query order (unique routes per query)
    route = jnp.where(is_q, sidx - nk, _DEAD_BIT)
    payload = (lo_at.astype(jnp.int64) << _IDX_BITS) | hi_at.astype(jnp.int64)
    _, rp = jax.lax.sort((route, payload), num_keys=1)
    lo = (rp[:nq] >> _IDX_BITS).astype(jnp.int32)
    hi = (rp[:nq] & _IDX_MASK).astype(jnp.int32)
    return lo, hi


def probe_ranges_fast(
    sorted_keys: jnp.ndarray,
    queries: jnp.ndarray,
    num_live: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(lo, hi) = searchsorted(live prefix of sorted_keys, queries,
    left/right), both int32 and clamped to ``num_live``.

    Runtime-dispatches (``lax.cond``) between the packed-merge fast path
    (live KEY span + 2 fits 31 bits) and the searchsorted fallback —
    both branches compile, the cheap one runs.  Query values play no part
    in the span: every query is clipped into [vmin-1, vmax+1], which
    preserves its order relative to every live key (a clipped query gets
    the correct lo == hi of 0 or num_live).  This matters beyond perf
    hygiene: dead probe slots routinely carry garbage keys (e.g. the
    unoccupied slots of an aggregation output feeding a join), and
    letting them into the span check silently forced the 4x-slower
    fallback on exactly the hot Q3-shaped plans."""
    nk = sorted_keys.shape[0]
    nq = queries.shape[0]
    keys64 = sorted_keys.astype(jnp.int64)
    q64 = queries.astype(jnp.int64)
    pos_k = jnp.arange(nk, dtype=jnp.int32)
    live = pos_k < num_live
    any_live = num_live > 0
    big = jnp.int64(1) << 62
    kmin = jnp.min(jnp.where(live, keys64, big))
    kmax = jnp.max(jnp.where(live, keys64, -big))
    vmin = jnp.where(any_live, kmin, jnp.int64(0))
    vmax = jnp.where(any_live, kmax, jnp.int64(0))
    fits = (
        (vmin >= -big) & (vmax <= big)
        & ((vmax - vmin) < jnp.int64((1 << _IDX_BITS) - 4))
    ) if nk + nq < (1 << _IDX_BITS) else jnp.bool_(False)

    def fast(_):
        base = vmin - 1
        span_hi = vmax - base + 1          # beyond any clipped query
        kv = jnp.where(live, keys64 - base, span_hi + 1)
        qv = jnp.clip(q64, vmin - 1, vmax + 1) - base
        return _merged_lo_hi(kv, qv, nk, nq)

    def slow(_):
        lo = jnp.searchsorted(keys64, q64, side="left",
                              method="sort").astype(jnp.int32)
        hi = jnp.searchsorted(keys64, q64, side="right",
                              method="sort").astype(jnp.int32)
        return lo, hi

    lo, hi = jax.lax.cond(fits, fast, slow, None)
    nl = num_live.astype(jnp.int32)
    return jnp.minimum(lo, nl), jnp.minimum(hi, nl)


def dense_inverse(cum: jnp.ndarray, num_out: int) -> jnp.ndarray:
    """``searchsorted(cum, arange(num_out), side="right")`` for a
    nondecreasing non-negative ``cum`` — the prefix-sum expansion address
    map (output slot -> source row) used by N:M joins, cross joins and
    shuffle row routing.

    Two single-operand packed sorts (queries are dense+sorted, so the
    route-back is also single-operand) instead of searchsorted's
    multi-operand sort + un-sort.  cum values clip to ``num_out``: slots
    only ask about thresholds below num_out, so the clip preserves every
    answer while keeping the packing in 31 bits."""
    n = cum.shape[0]
    assert num_out < (1 << 30) and n + num_out < (1 << _IDX_BITS)
    kv = jnp.minimum(cum, num_out).astype(jnp.int64) * 2
    qv = jnp.arange(num_out, dtype=jnp.int64) * 2 + 1  # cum[i] <= t sorts first
    vals = jnp.concatenate([kv, qv])
    m = n + num_out
    idx = jnp.arange(m, dtype=jnp.int64)
    s = jax.lax.sort((vals << _IDX_BITS) | idx)
    sidx = s & _IDX_MASK
    is_q = sidx >= n
    cnt_q_excl = jnp.cumsum(is_q.astype(jnp.int32)) - is_q.astype(jnp.int32)
    pos = jnp.arange(m, dtype=jnp.int32)
    hi_at = (pos - cnt_q_excl).astype(jnp.int64)
    packed2 = jnp.where(is_q, ((sidx - n) << _IDX_BITS) | hi_at, _DEAD_BIT)
    s2 = jax.lax.sort(packed2)
    return (s2[:num_out] & _IDX_MASK).astype(jnp.int32)


__all__ = ["flagged_positions", "probe_ranges_fast", "dense_inverse"]
