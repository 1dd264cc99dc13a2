"""Host-side table provider ("storage engine").

Role analog: the read-side of ``StorageDeltaMerge``/``MockStorage``
(``Debug/MockStorage.h``) — SURVEY.md scopes the DeltaTree storage engine
out of this build; tables are columnar host arrays staged into device
memory at load.  Columns are built straight from numpy arrays (no
python-object round trip) so SF≥1 loads stay fast.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Column
from ..core.dtypes import DataType, TypeKind


def column_from_arrays(
    data: np.ndarray,
    dtype: DataType,
    validity: Optional[np.ndarray] = None,
    dictionary: Optional[Tuple[str, ...]] = None,
) -> Column:
    """Zero-copy-ish column construction from numpy.

    For STRING columns the caller provides int32 codes + the sorted
    dictionary (order-preserving codes contract, see core/block.py).

    Integer-family columns get (vmin, vmax) range stats computed here —
    the per-pack MinMaxIndex analog
    (``Storages/DeltaMerge/Index/MinMaxIndex.h``) that drives capacity
    auto-sizing, decimal limb planning and rough-set filtering."""
    stats = None
    if dtype.is_string:
        assert dictionary is not None, "string columns need a dictionary"
        assert data.dtype == np.int32
    else:
        data = np.ascontiguousarray(data, dtype=dtype.physical)
        if data.size and np.issubdtype(data.dtype, np.integer):
            stats = (int(data.min()), int(data.max()))
    v = None if validity is None else jnp.asarray(np.ascontiguousarray(validity, dtype=bool))
    return Column(jnp.asarray(data), v, dtype, dictionary, stats=stats)


def encode_strings(values: np.ndarray) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Sort-order dictionary encoding of a numpy string array."""
    uniq, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int32), tuple(uniq.tolist())


def _merge_dictionaries(a: Column, b: Column):
    """Re-encode two dictionary string columns into one merged sorted
    dictionary (codes stay order-preserving)."""
    import jax.numpy as jnp

    da = a.dictionary or ()
    db = b.dictionary or ()
    merged = tuple(sorted(set(da) | set(db)))
    rank = {s: i for i, s in enumerate(merged)}

    def remap(col, src):
        table = np.array([rank[s] for s in src] or [0], dtype=np.int32)
        data = jnp.asarray(table)[jnp.clip(col.data, 0, max(len(src) - 1, 0))]
        return Column(data, col.validity, col.dtype, merged)

    return remap(a, da), remap(b, db)


@dataclasses.dataclass
class TableDef:
    name: str
    block: Block
    schema: Dict[str, DataType]
    # planner hints (the stats analog of TiDB's table statistics)
    unique_keys: Tuple[Tuple[str, ...], ...] = ()
    row_count: int = 0


class Catalog:
    """In-memory schema + data registry (the TiDB InfoSchema / SchemaSyncer
    analog, ``TiDB/Schema/TiDBSchemaSyncer.h:32`` — here just a dict)."""

    def __init__(self):
        self.tables: Dict[str, TableDef] = {}

    def register(
        self,
        name: str,
        columns: Dict[str, Column],
        unique_keys: Sequence[Sequence[str]] = (),
        clustered_by: Sequence[str] = (),
    ) -> TableDef:
        """``clustered_by``: physical-layout hint — rows with equal values
        in these columns are adjacent (the DeltaTree stable layer is
        PK-sorted; scans of it carry this property).  Enables StreamAgg."""
        block = Block.from_dict(columns)
        if clustered_by:
            block = dataclasses.replace(block, clustered_by=tuple(clustered_by))
        # exact NDV for key columns — free for single-column unique keys
        # (= row count), one adjacent-diff pass for the leading clustered
        # column.  The TiDB-stats analog the reference planner receives;
        # drives exact capacity auto-sizing (plan/auto.py).
        ndvs: Dict[str, int] = {}
        for uk in unique_keys:
            if len(uk) == 1 and uk[0] in block.names:
                ndvs[uk[0]] = block.capacity
        lead = tuple(clustered_by)[:1]
        if lead and lead[0] in block.names and lead[0] not in ndvs:
            c = block[lead[0]]
            if c.data.ndim == 1 and not c.dtype.is_string:
                host = np.asarray(c.data)
                if host.size:
                    ndvs[lead[0]] = int((host[1:] != host[:-1]).sum()) + 1
        if ndvs:
            cols2 = {n: (dataclasses.replace(c, ndv=ndvs[n])
                         if n in ndvs else c)
                     for n, c in zip(block.names, block.columns)}
            block = dataclasses.replace(
                block, columns=tuple(cols2[n] for n in block.names))
        td = TableDef(
            name=name,
            block=block,
            schema={n: c.dtype for n, c in columns.items()},
            unique_keys=tuple(tuple(k) for k in unique_keys),
            row_count=block.capacity,
        )
        self.tables[name] = td
        return td

    def append(self, name: str, columns: Dict[str, Column]) -> TableDef:
        """Append rows to a table (the write-path analog: the reference
        ingests via Raft into DeltaTree memtables; here host-side block
        concatenation — dictionaries are merged order-preservingly)."""
        td = self.tables[name]
        new_block = Block.from_dict(columns)
        merged_cols: Dict[str, Column] = {}
        for cname in td.block.names:
            a = td.block[cname]
            b = new_block[cname]
            if a.dtype.is_string:
                a, b = _merge_dictionaries(a, b)
            import jax.numpy as jnp

            data = jnp.concatenate([a.data, b.data])
            if a.validity is None and b.validity is None:
                validity = None
            else:
                validity = jnp.concatenate([a.valid_mask(), b.valid_mask()])
            merged_cols[cname] = Column(data, validity, a.dtype, a.dictionary)
        # appended rows break adjacency at the seam: clustering is dropped
        td.block = Block.from_dict(merged_cols)
        td.row_count = td.block.capacity
        return td

    def blocks(self) -> Dict[str, Block]:
        return {n: t.block for n, t in self.tables.items()}

    def __getitem__(self, name: str) -> TableDef:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables


__all__ = ["Catalog", "TableDef", "column_from_arrays", "encode_strings"]
