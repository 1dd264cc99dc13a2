"""Unit tests for the packed-sort merge primitives (ops/merge.py) vs
numpy searchsorted oracles, including fallback and edge cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tiflash_jax.ops.merge import flagged_positions, probe_ranges_fast


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_out", [4, 64, 200])
def test_flagged_positions(seed, num_out):
    rng = np.random.default_rng(seed)
    flags = rng.random(128) < 0.3
    got = np.asarray(jax.jit(flagged_positions,
                             static_argnums=1)(jnp.asarray(flags), num_out))
    want = np.flatnonzero(flags)
    k = min(len(want), num_out)
    assert (got[:k] == want[:k]).all()
    assert (got[k:] == -1).all()
    assert got.shape == (num_out,)


def test_flagged_positions_none_set():
    got = np.asarray(flagged_positions(jnp.zeros(16, bool), 8))
    assert (got == -1).all()


def _ref_ranges(live_keys, queries):
    lo = np.searchsorted(live_keys, queries, side="left")
    hi = np.searchsorted(live_keys, queries, side="right")
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("span", ["small", "huge"])
def test_probe_ranges_fast_matches_searchsorted(seed, span):
    """Fast packed path (small span) and searchsorted fallback (huge
    span) must both equal the numpy oracle on the live prefix."""
    rng = np.random.default_rng(seed)
    nk, nq = 200, 333
    if span == "small":
        keys = rng.integers(-50, 50, nk)
        queries = rng.integers(-80, 80, nq)
    else:  # span > 2^31: runtime cond must take the fallback branch
        keys = rng.integers(-(2 ** 40), 2 ** 40, nk)
        queries = rng.integers(-(2 ** 41), 2 ** 41, nq)
    num_live = rng.integers(0, nk + 1)
    live = np.sort(keys[:num_live])
    skeys = np.concatenate(
        [live, np.full(nk - num_live, 2 ** 63 - 1, dtype=np.int64)])
    lo, hi = jax.jit(probe_ranges_fast)(
        jnp.asarray(skeys), jnp.asarray(queries),
        jnp.int32(num_live))
    wlo, whi = _ref_ranges(live, queries)
    np.testing.assert_array_equal(np.asarray(lo), wlo)
    np.testing.assert_array_equal(np.asarray(hi), whi)


def test_probe_ranges_sentinel_value_key():
    """A probe key equal to the +inf sentinel must clamp to num_live and
    never 'match' the dead suffix."""
    big = 2 ** 63 - 1
    skeys = jnp.asarray(np.array([1, 5, 9, big, big], dtype=np.int64))
    lo, hi = probe_ranges_fast(skeys, jnp.asarray(np.array([big, 5],
                                                           dtype=np.int64)),
                               jnp.int32(3))
    assert int(lo[0]) == 3 and int(hi[0]) == 3   # no match in live prefix
    assert int(lo[1]) == 1 and int(hi[1]) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_ranges_garbage_queries_small_key_span(seed):
    """Narrow LIVE key span + wild query values (dead probe slots carry
    garbage, e.g. unoccupied aggregation-output slots feeding a join):
    the query values must not disable the packed fast path, and clipped
    queries must still get exact lo/hi (0 or num_live)."""
    rng = np.random.default_rng(seed)
    nk, nq = 150, 400
    keys = rng.integers(1000, 2000, nk)
    num_live = int(rng.integers(1, nk + 1))
    live = np.sort(keys[:num_live])
    skeys = np.concatenate(
        [live, np.full(nk - num_live, 2 ** 63 - 1, dtype=np.int64)])
    queries = rng.integers(900, 2100, nq)
    wild = rng.integers(0, nq, 40)
    queries[wild[:20]] = rng.integers(-(2 ** 62), -(2 ** 40), 20)
    queries[wild[20:]] = rng.integers(2 ** 40, 2 ** 62, 20)
    lo, hi = jax.jit(probe_ranges_fast)(
        jnp.asarray(skeys), jnp.asarray(queries), jnp.int32(num_live))
    wlo, whi = _ref_ranges(live, queries)
    np.testing.assert_array_equal(np.asarray(lo), wlo)
    np.testing.assert_array_equal(np.asarray(hi), whi)


def test_probe_ranges_empty_live():
    skeys = jnp.full(8, 2 ** 63 - 1, dtype=jnp.int64)
    lo, hi = probe_ranges_fast(skeys, jnp.arange(5, dtype=jnp.int64),
                               jnp.int32(0))
    assert (np.asarray(lo) == 0).all() and (np.asarray(hi) == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_out", [1, 7, 64])
def test_dense_inverse(seed, num_out):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, 20)
    cum = np.cumsum(counts)
    got = np.asarray(jax.jit(lambda c: __import__(
        "tiflash_jax.ops.merge", fromlist=["dense_inverse"]
    ).dense_inverse(c, num_out))(jnp.asarray(cum)))
    want = np.searchsorted(cum, np.arange(num_out), side="right")
    np.testing.assert_array_equal(got, want.astype(np.int32))
