"""Segment-boundary fills and permutation routing without scatters.

Forward fills are one native ``lax.cummax`` scan (``jnp.maximum.accumulate``
lowers far worse), and permutation routing (``out[pos[i]] = val[i]``) is a
2-operand sort instead of a random scatter.  Both choices follow the cost
model of the accelerator the engine was first built for; whether a
scatter is cheaper on the GPU is ROADMAP queue 3 item 4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def forward_fill_positions(flags: jnp.ndarray) -> jnp.ndarray:
    """Position (int32) of the most recent True at or before each row.
    ``flags[0]`` must be True."""
    n = flags.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(flags, pos, jnp.int32(-1)))


def backward_fill_positions(flags: jnp.ndarray) -> jnp.ndarray:
    """Position (int32) of the nearest True at or after each row.
    ``flags[-1]`` must be True."""
    n = flags.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.cummin(jnp.where(flags, pos, jnp.int32(n)), reverse=True)


def route_by_positions(positions: jnp.ndarray, values: jnp.ndarray) -> jnp.ndarray:
    """``out[positions[i]] = values[i]`` for a PERMUTATION ``positions``
    (each target hit exactly once) — one 2-operand sort instead of a
    random scatter.  Bool values ride as int8 and convert back."""
    vals = values
    as_bool = vals.dtype == jnp.bool_
    if as_bool:
        vals = vals.astype(jnp.int8)
    _, routed = jax.lax.sort(
        (positions.astype(jnp.int32), vals), num_keys=1
    )
    return routed.astype(jnp.bool_) if as_bool else routed


__all__ = ["forward_fill_positions", "backward_fill_positions",
           "route_by_positions"]
