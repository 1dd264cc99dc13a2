"""Vectorized row hashing for group-by / join / shuffle partitioning.

Role analog: the reference's CRC32 key hashing in ``Common/HashTable/Hash.h``
and ``IColumn::updateWeakHash32`` (``Columns/IColumn.h``) used by
``HashBaseWriterHelper`` (``Flash/Mpp/HashBaseWriterHelper.h:29-49``) for the
exchange partitioner.

The hash mixes in uint32 space — two murmur3-style fmix32 lanes over the
(hi, lo) halves of each 64-bit key — so it never needs a 64-bit
multiply.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Column

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_SEED_MIX = np.uint32(0x9E3779B9)  # golden-ratio combine like boost


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> 16)
    h = h * _C1
    h = h ^ (h >> 13)
    h = h * _C2
    h = h ^ (h >> 16)
    return h


def hash_array_u32(data: jnp.ndarray, init: jnp.ndarray | None = None) -> jnp.ndarray:
    """Hash one column's values to uint32, combining with ``init`` if given."""
    if data.dtype == jnp.bool_:
        data = data.astype(jnp.uint32)
    itemsize = jnp.dtype(data.dtype).itemsize
    if itemsize == 8:
        bits = data.view(jnp.uint64) if data.dtype != jnp.uint64 else data
        lo = (bits & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        hi = (bits >> jnp.uint64(32)).astype(jnp.uint32)
        h = _fmix32(lo) ^ _fmix32(hi * _C1)
    else:
        h = _fmix32(data.astype(jnp.uint32))
    if init is not None:
        # boost::hash_combine-style merge so column order matters
        h = init ^ (h + _SEED_MIX + (init << 6) + (init >> 2))
        h = _fmix32(h)
    return h


def _fnv1a32_host(s: str) -> int:
    """Host-side FNV-1a over utf-8 bytes — a dictionary-INDEPENDENT string
    hash.  Hashing raw dictionary codes would send equal strings encoded
    under different dictionaries to different shuffle partitions (matches
    silently lost); hashing the string VALUE via a per-entry LUT keeps the
    partitioner consistent across any encodings (reference hashes the
    string bytes themselves: ``Columns/ColumnString.h updateWeakHash32``)."""
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def string_value_hashes(col: Column) -> jnp.ndarray:
    """Per-row uint32 value hashes for a dictionary-encoded string column:
    host LUT over the (static, trace-time) dictionary, one device gather."""
    d = col.dictionary or ()
    lut = np.fromiter(
        (_fnv1a32_host(s) for s in d), dtype=np.uint32, count=len(d)
    ) if d else np.zeros(1, dtype=np.uint32)
    return jnp.asarray(lut)[jnp.clip(col.data, 0, len(lut) - 1)]


def hash_columns(
    cols: Sequence[Column], *, null_sentinel: bool = True, seed: int = 0
) -> jnp.ndarray:
    """Combined uint32 hash over multiple key columns.

    NULL hashes to a fixed sentinel distinct from any value hash bucket
    choice (reference: nullable key methods hash the null map too).
    Dictionary-encoded strings hash by VALUE (see string_value_hashes) so
    two sides of an exchange agree regardless of their encodings."""
    h = jnp.uint32(seed) if seed else None
    for col in cols:
        data = string_value_hashes(col) if col.dictionary is not None else col.data
        hc = hash_array_u32(data, init=h)
        if col.validity is not None and null_sentinel:
            hc = jnp.where(col.validity, hc, jnp.uint32(0xDEADBEEF) ^ (h if h is not None else jnp.uint32(0)))
        h = hc
    assert h is not None, "hash_columns needs at least one column"
    return h


def hash_columns_u63(cols: Sequence[Column], **kw) -> jnp.ndarray:
    """Two independent 32-bit lanes combined into a non-negative int64
    (for hash+verify join keys wider than 63 bits)."""
    h1 = hash_columns(cols, **kw).astype(jnp.uint64)
    h2 = hash_columns(cols, seed=0x6A09E667, **kw).astype(jnp.uint64)
    return (((h1 << jnp.uint64(31)) ^ h2) & jnp.uint64(2**62 - 1)).astype(jnp.int64)


def hash_block_keys(block: Block, key_names: Sequence[str]) -> jnp.ndarray:
    return hash_columns([block[k] for k in key_names])


def partition_ids(hashes: jnp.ndarray, num_partitions: int) -> jnp.ndarray:
    """Map hashes to partition ids [0, P).  Uses the high bits via a
    multiply-shift so partition and hash-table slot bits stay independent
    (the reference uses %, we avoid integer division)."""
    # (hash * P) >> 32 — multiplicative range reduction
    wide = hashes.astype(jnp.uint64) * jnp.uint64(num_partitions)
    return (wide >> jnp.uint64(32)).astype(jnp.int32)


__all__ = [
    "hash_array_u32",
    "hash_columns",
    "hash_block_keys",
    "partition_ids",
    "string_value_hashes",
]
