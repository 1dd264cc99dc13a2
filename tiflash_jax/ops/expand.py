"""Expand: grouping-sets replication (ROLLUP/CUBE support).

Role analog: ``Interpreters/Expand.h`` / ``Expand2.h`` and the
``tipb::Expand/Expand2`` executors — each input row is replicated once per
grouping set, with the key columns not in that set NULLed out and a
``groupingID`` column appended (TiDB's grouping-function marker).

Design: static replication — concatenate G masked copies (capacity
G x n).  XLA fuses the masking; the following aggregation sees one block.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

from ..core.block import Block, Column
from ..core.dtypes import INT64


def expand_block(
    block: Block, grouping_sets: Sequence[Sequence[str]], gid_name: str = "groupingID"
) -> Block:
    """Replicate rows per grouping set; key columns outside the set become
    NULL; adds int64 ``gid_name`` (1-based like TiDB's grouping id)."""
    g = len(grouping_sets)
    n = block.capacity
    all_keys = {k for s in grouping_sets for k in s}
    pieces: List[Block] = []
    out_cols = {}
    for name, col in zip(block.names, block.columns):
        parts_data = []
        parts_valid = []
        for si, s in enumerate(grouping_sets):
            if name in all_keys and name not in s:
                parts_data.append(jnp.zeros_like(col.data))
                parts_valid.append(jnp.zeros(n, dtype=jnp.bool_))
            else:
                parts_data.append(col.data)
                parts_valid.append(col.valid_mask())
        data = jnp.concatenate(parts_data)
        validity = jnp.concatenate(parts_valid)
        nullable = name in all_keys and any(
            name not in s for s in grouping_sets
        )
        dtype = col.dtype.with_nullable(col.dtype.nullable or nullable)
        out_cols[name] = Column(
            data, validity if (nullable or col.validity is not None) else None,
            dtype, col.dictionary,
        )
    gid = jnp.repeat(jnp.arange(1, g + 1, dtype=jnp.int64), n)
    out_cols[gid_name] = Column(gid, None, INT64)
    sel = jnp.tile(block.sel_mask(), g)
    return Block.from_dict(out_cols, sel=sel)


__all__ = ["expand_block"]
