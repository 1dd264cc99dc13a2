"""Columnar batch types: ``Column`` and ``Block``.

Role analog: ``dbms/src/Core/Block.h:41`` and ``dbms/src/Columns/IColumn.h:61``
in the reference.  Key re-design decisions for a shape-static device:

- A column is a fixed-width device array plus an optional validity mask
  (reference ``ColumnNullable`` null-map, inverted: here True == valid).
- A block optionally carries a row-selection mask ``sel`` instead of
  physically compacting rows (reference ``BlockInfo::selective``,
  ``Core/BlockInfo.h:47-49``).  On device compaction costs a gather, while a
  mask fuses into downstream elementwise work for free, so *every* operator
  honors ``sel`` and filters stay lazy until a shuffle or an output forces
  materialization.
- All shapes are static: a block has a fixed row *capacity*; the live row
  count is the popcount of ``sel`` (a traced scalar).  Data-dependent row
  counts (filter/join/group-by) therefore produce full-capacity blocks with
  a mask — the "bounded output + count" pattern from SURVEY.md §7.

Columns/Blocks are registered pytrees so whole blocks flow through
``jax.jit`` / ``shard_map`` directly.  String dictionaries are host-side
aux data (hashable tuples) — the device only ever sees int32 codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import DataType, TypeKind, STRING


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Column:
    """One column: fixed-width values + optional validity mask.

    ``data``     — jnp array, shape (n,), physical dtype of ``dtype``.
    ``validity`` — optional bool array (n,); True = value present.  None
                   means all-valid (non-nullable fast path).
    ``dtype``    — logical type (aux data, static under jit).
    ``dictionary`` — for STRING columns, tuple of python strings; device
                   data are int32 indexes into it.  -1 is never used; NULL
                   strings are NULL via validity.
    """

    data: jnp.ndarray
    validity: Optional[jnp.ndarray] = None
    dtype: DataType = dataclasses.field(default=None)  # type: ignore[assignment]
    dictionary: Optional[Tuple[str, ...]] = None
    # group_concat result columns: data is (n, max_items) dictionary codes,
    # validity the matching item mask; joined with this separator on decode
    concat_sep: Optional[str] = None
    # value-range statistics (vmin, vmax) of the PHYSICAL data, host ints —
    # the rough-set index analog of the reference's per-pack MinMaxIndex
    # (``Storages/DeltaMerge/Index/MinMaxIndex.h``).  Set by the storage
    # layer at load; an INVARIANT: every live value lies in [vmin, vmax].
    # Transformations must drop or widen it (with_data drops by default).
    stats: Optional[Tuple[int, int]] = None
    # exact host-known VALUE SET of an integer column (sorted tuple of
    # python ints) — the numeric analog of a string dictionary, set by
    # the storage layer for low-NDV columns.  INVARIANT: every live value
    # is in ``domain``.  Enables string-producing LUT functions
    # (bin/hex/elt/lpad/...) over columns whose [min, max] span is far
    # wider than the LUT budget.  Dropped by every transformation.
    domain: Optional[Tuple[int, ...]] = None
    # PROVEN upper bound on the number of distinct live values (exact NDV
    # at load for key columns — unique/clustered counts are free there).
    # INVARIANT: filters/joins/1:1 maps only preserve or shrink the
    # distinct set, so a group-by on this column has <= ndv + 1 groups
    # (+1 for the NULL group).  The TiDB-stats analog the reference's
    # planner receives; lets the capacity auto-sizer pick EXACT agg
    # capacities instead of sampled-extrapolation x headroom.
    ndv: Optional[int] = None

    # -- pytree protocol --
    def tree_flatten(self):
        return (self.data, self.validity), (
            self.dtype, self.dictionary, self.concat_sep, self.stats,
            self.domain, self.ndv,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, validity = children
        dtype, dictionary, concat_sep, stats, domain, ndv = aux
        return cls(data=data, validity=validity, dtype=dtype,
                   dictionary=dictionary, concat_sep=concat_sep, stats=stats,
                   domain=domain, ndv=ndv)

    # -- basics --
    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self) -> jnp.ndarray:
        """Always-materialized bool mask (all-True if validity is None)."""
        if self.validity is None:
            return jnp.ones(self.data.shape[0], dtype=jnp.bool_)
        return self.validity

    def with_data(self, data, validity="_keep", stats=None) -> "Column":
        """New data, same metadata.  ``stats`` must be re-supplied by the
        caller when still valid — new values void the old range."""
        v = self.validity if validity == "_keep" else validity
        return Column(data=data, validity=v, dtype=self.dtype,
                      dictionary=self.dictionary, concat_sep=self.concat_sep,
                      stats=stats)

    def take(self, indices: jnp.ndarray, fill_invalid: bool = False) -> "Column":
        """Gather rows (reference ``IColumn::permute`` / ``index``).

        If ``fill_invalid`` the caller passes indices that may be negative;
        those rows become NULL.  Gathers permute/subset existing values, so
        range stats survive."""
        safe = jnp.maximum(indices, 0)
        data = jnp.take(self.data, safe, axis=0)
        validity = None if self.validity is None else jnp.take(self.validity, safe, axis=0)
        if fill_invalid:
            ok = indices >= 0
            validity = ok if validity is None else (validity & ok)
        return self.with_data(data, validity, stats=self.stats)

    # -- host conversion (testing / output) --
    def to_numpy(self) -> np.ndarray:
        """Materialize to a numpy array; NULLs become a masked numpy array's
        fill is left to the caller — here NULL slots keep raw values."""
        return np.asarray(self.data)

    def to_pylist(self, sel: Optional[np.ndarray] = None) -> list:
        """Decode to python values (strings decoded, decimals as scaled int
        left intact — formatting is the responsibility of the printer)."""
        data = np.asarray(self.data)
        if self.dtype.is_wide_decimal and data.ndim == 2:
            # two-limb mantissa (core/wide.py): python bigints out.
            # 1-D wide columns are "narrow-stored" (the int64 mantissa
            # provably fits — ops/aggregate._wide_rewrite) and decode below
            # like any other decimal.
            from .wide import wide_to_host_ints

            valid = None if self.validity is None else np.asarray(self.validity)
            if sel is not None:
                data = data[sel]
                valid = None if valid is None else valid[sel]
            return wide_to_host_ints(data, valid)
        if self.dtype.is_vector and data.ndim == 2:
            valid = (
                np.ones(data.shape[0], dtype=bool)
                if self.validity is None
                else np.asarray(self.validity)
            )
            if sel is not None:
                data = data[sel]
                valid = valid[sel]
            return [tuple(row) if ok else None
                    for row, ok in zip(data.tolist(), valid.tolist())]
        if data.ndim == 2:
            # group_concat column: join each row's valid dictionary items
            sep = self.concat_sep if self.concat_sep is not None else ","
            valid = (
                np.ones(data.shape, dtype=bool)
                if self.validity is None
                else np.asarray(self.validity)
            )
            if sel is not None:
                data = data[sel]
                valid = valid[sel]
            out = []
            for row, ok_row in zip(data.tolist(), valid.tolist()):
                items = [self.dictionary[c] for c, ok in zip(row, ok_row) if ok]
                out.append(sep.join(items) if items else None)
            return out
        valid = (
            np.ones(len(data), dtype=bool)
            if self.validity is None
            else np.asarray(self.validity)
        )
        if sel is not None:
            data = data[sel]
            valid = valid[sel]
        out = []
        for v, ok in zip(data.tolist(), valid.tolist()):
            if not ok:
                out.append(None)
            elif self.dictionary is not None:
                out.append(self.dictionary[v])
            else:
                out.append(v)
        return out


def _json_order_key(s: str):
    """Total order matching MySQL JSON comparison precedence
    (json_contains_path.test ORDER BY over a JSON column)."""
    import json as _json

    def k(v):
        if v is None:
            return (0,)
        if isinstance(v, bool):
            return (6, v)
        if isinstance(v, (int, float)):
            return (1, float(v))
        if isinstance(v, str):
            return (2, v)
        if isinstance(v, dict):
            return (3, len(v),
                    tuple(sorted((kk, k(vv)) for kk, vv in v.items())))
        return (4, tuple(k(x) for x in v), len(v))

    try:
        return k(_json.loads(s)) if s else (0,)
    except Exception:
        return (9, s)


def column_from_numpy(
    values: Sequence, dtype: DataType, validity: Optional[Sequence[bool]] = None
) -> Column:
    """Build a device Column from host data.  For STRING dtype, ``values``
    are python strings and get dictionary-encoded here."""
    if dtype.is_vector:
        dims = dtype.precision
        rows = [np.zeros(dims, dtype=np.float32) if v is None
                else np.asarray(v, dtype=np.float32) for v in values]
        data = jnp.asarray(np.stack(rows)) if rows else \
            jnp.zeros((0, dims), dtype=jnp.float32)
        v = None
        if validity is not None:
            v = jnp.asarray(np.asarray(validity, dtype=bool))
        elif any(x is None for x in values):
            v = jnp.asarray(np.array([x is not None for x in values]))
        return Column(data=data, validity=v, dtype=dtype)
    if dtype.is_string:
        # Order-preserving dictionary: codes are ranks in the sorted set of
        # distinct strings, so integer comparisons on codes == binary-collation
        # string comparisons (reference: ``TiDB/Collation`` binary collator).
        # JSON columns rank by MySQL JSON precedence (number < string <
        # object < array < boolean) so ORDER BY follows JSON semantics.
        values = list(values)
        arr = np.array(["" if s is None else s for s in values], dtype=object)
        if dtype.mysql_json:
            uniq_sorted = sorted(set(arr.tolist()), key=_json_order_key)
        else:
            uniq_sorted = sorted(set(arr.tolist()))
        rank = {s: i for i, s in enumerate(uniq_sorted)}
        codes = np.fromiter((rank[s] for s in arr.tolist()), dtype=np.int32, count=len(arr))
        data = jnp.asarray(codes)
        dictionary = tuple(uniq_sorted)
    elif dtype.is_wide_decimal:
        # python bigint mantissas -> L int64 limbs (core/wide.py layout:
        # top limb signed, lower limbs in [0, 10^18))
        W18 = 10 ** 18
        L = dtype.decimal_limbs
        vals = [0 if v is None else int(v) for v in values]
        arr = np.zeros((len(vals), L), dtype=np.int64)
        for i, v in enumerate(vals):
            for j in range(L - 1, 0, -1):  # python %/// floor: limbs >= 0
                arr[i, j] = v % W18
                v //= W18
            arr[i, 0] = v  # signed top limb
        data = jnp.asarray(arr)
        dictionary = None
    else:
        data = jnp.asarray(np.asarray(values, dtype=dtype.physical))
        dictionary = None
    v = None
    if validity is not None:
        v = jnp.asarray(np.asarray(validity, dtype=bool))
    elif dtype.is_string and any(s is None for s in values):
        v = jnp.asarray(np.array([s is not None for s in values]))
    stats = None
    domain = None
    if not dtype.is_string and not dtype.is_wide_decimal:
        # (two-limb wide decimals carry no int64 range stats)
        host_all = np.asarray(values, dtype=dtype.physical)
        host = host_all
        if validity is not None:
            host = host_all[np.asarray(validity, dtype=bool)]
        if host.size and np.issubdtype(host.dtype, np.integer):
            stats = (int(host.min()), int(host.max()))
            if host.size <= 65536:
                uniq = np.unique(host)
                if uniq.size <= 4096:
                    domain = tuple(int(x) for x in uniq)
        elif host.size and np.issubdtype(host.dtype, np.floating) \
                and np.isfinite(host).all():
            # integer envelope of a float column: enables the rounded
            # int-LUT string producers (HEX/BIN/FORMAT over doubles)
            stats = (int(np.floor(host.min() + 0.5)) - 1,
                     int(np.floor(host.max() + 0.5)) + 1)
            if host.size <= 65536:
                uniq = np.unique(host)
                if uniq.size <= 4096:
                    domain = tuple(float(x) for x in uniq)
    return Column(data=data, validity=v, dtype=dtype, dictionary=dictionary,
                  stats=stats, domain=domain)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Block:
    """An ordered set of equal-length named columns + optional row mask.

    Reference: ``Core/Block.h:41``.  ``sel`` plays the role of
    ``BlockInfo::selective``: rows where sel is False are dead (filtered
    out or padding) and must be ignored by every consumer.
    """

    names: Tuple[str, ...]
    columns: Tuple[Column, ...]
    sel: Optional[jnp.ndarray] = None  # bool (n,) or None == all rows live
    # Physical clustering property: rows with equal values in these columns
    # are ADJACENT (the reference's DeltaTree stable layer is PK-sorted;
    # TiDB plans StreamAgg over such order).  Only equal-adjacency is ever
    # relied upon, not full ordering.  Static aux data under jit.
    clustered_by: Tuple[str, ...] = ()

    # -- pytree protocol --
    def tree_flatten(self):
        return (self.columns, self.sel), (self.names, self.clustered_by)

    @classmethod
    def tree_unflatten(cls, aux, children):
        names, clustered_by = aux
        columns, sel = children
        return cls(names=names, columns=columns, sel=sel, clustered_by=clustered_by)

    # -- construction --
    @staticmethod
    def from_dict(cols: Dict[str, Column], sel=None) -> "Block":
        return Block(names=tuple(cols.keys()), columns=tuple(cols.values()), sel=sel)

    # -- access --
    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __getitem__(self, name: str) -> Column:
        try:
            return self.columns[self.names.index(name)]
        except ValueError:
            raise KeyError(f"column {name!r} not in block {self.names}") from None

    def as_dict(self) -> Dict[str, Column]:
        return dict(zip(self.names, self.columns))

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return self.columns[0].capacity

    def num_rows(self) -> jnp.ndarray:
        """Live row count — a traced scalar under jit."""
        if self.sel is None:
            return jnp.int32(self.capacity)
        return jnp.sum(self.sel, dtype=jnp.int32)

    def sel_mask(self) -> jnp.ndarray:
        if self.sel is None:
            return jnp.ones(self.capacity, dtype=jnp.bool_)
        return self.sel

    # -- transformation --
    def with_sel(self, sel: Optional[jnp.ndarray]) -> "Block":
        return Block(names=self.names, columns=self.columns, sel=sel,
                     clustered_by=self.clustered_by)

    def and_sel(self, mask: jnp.ndarray) -> "Block":
        """Narrow the selection (a lazy filter — physical order unchanged,
        so clustering survives)."""
        new = mask if self.sel is None else (self.sel & mask)
        return self.with_sel(new)

    def select(self, names: Sequence[str]) -> "Block":
        missing = [n for n in names if n not in self.names]
        if missing:
            raise KeyError(f"columns {missing} not in block {list(self.names)}")
        cols = self.as_dict()
        kept = self.clustered_by
        if kept and any(k not in names for k in kept):
            # clustering by a prefix still holds if only a suffix is dropped
            keep_n = 0
            for k in kept:
                if k in names:
                    keep_n += 1
                else:
                    break
            kept = kept[:keep_n]
        return Block(
            names=tuple(names),
            columns=tuple(cols[n] for n in names),
            sel=self.sel,
            clustered_by=kept,
        )

    def with_column(self, name: str, col: Column) -> "Block":
        d = self.as_dict()
        d[name] = col
        kept = self.clustered_by
        if name in kept:
            # replacing a clustering column invalidates the property from
            # that column onward (data may no longer be adjacent-equal)
            kept = kept[: kept.index(name)]
        return Block(names=tuple(d.keys()), columns=tuple(d.values()),
                     sel=self.sel, clustered_by=kept)

    def take(self, indices: jnp.ndarray, fill_invalid: bool = False) -> "Block":
        """Gather rows by index into a new block (sel dropped/absorbed).

        All 1-D columns (ints widened, floats bitcast, validities as extra
        lanes) pack into ONE (n, k) int64 row matrix gathered once: a
        random gather pays a per-row cost that one wide gather pays once
        for all columns (not yet re-measured on the GPU: ROADMAP queue 1).
        Widening copies are table-sized elementwise passes.  For small
        index sets the packing pass would dominate, so those stay
        per-column."""
        n_idx = int(indices.shape[0])
        if n_idx < self.capacity or len(self.columns) < 2:
            cols = tuple(c.take(indices, fill_invalid) for c in self.columns)
            return Block(names=self.names, columns=cols, sel=None)

        safe = jnp.maximum(indices, 0)
        ok = (indices >= 0) if fill_invalid else None

        lanes = []      # int64 (n,) arrays to stack
        restore = []    # (col_idx, kind, dtype) per lane
        results = {}    # (col_idx, kind) -> gathered array
        for i, c in enumerate(self.columns):
            for kind, arr in (("data", c.data), ("validity", c.validity)):
                if arr is None:
                    continue
                if arr.ndim != 1:  # 2-D payloads (group_concat) gather alone
                    results[(i, kind)] = jnp.take(arr, safe, axis=0)
                    continue
                restore.append((i, kind, arr.dtype))
                if jnp.issubdtype(arr.dtype, jnp.floating):
                    lanes.append(jax.lax.bitcast_convert_type(
                        arr.astype(jnp.float64), jnp.int64))
                else:  # ints / bool / uint
                    lanes.append(arr.astype(jnp.int64))
        if lanes:
            if len(lanes) == 1:
                moved = jnp.take(lanes[0], safe)[:, None]
            else:
                moved = jnp.take(jnp.stack(lanes, axis=1), safe, axis=0)
            for j, (i, kind, dt) in enumerate(restore):
                lane = moved[:, j]
                if jnp.issubdtype(dt, jnp.floating):
                    lane = jax.lax.bitcast_convert_type(lane, jnp.float64)
                # astype to the lane's own dtype is a no-op
                results[(i, kind)] = lane.astype(dt)
        cols = []
        for i, c in enumerate(self.columns):
            data = results[(i, "data")]
            validity = results.get((i, "validity"))
            if ok is not None:
                validity = ok if validity is None else (validity & ok)
            cols.append(Column(data, validity, c.dtype, c.dictionary,
                               stats=c.stats))
        return Block(names=self.names, columns=tuple(cols), sel=None)

    def compact(self) -> "Block":
        """Physically pack live rows to the front (same capacity).

        Prefix-sum + gather: the device analog of the two-pass
        ``countBytesInFilter`` + ``filterColumn`` split
        (``Columns/countBytesInFilter.cpp``).  Output keeps static capacity;
        rows >= count are marked dead in sel.
        """
        if self.sel is None:
            return self
        n = self.capacity
        mask = self.sel
        count = jnp.sum(mask, dtype=jnp.int32)
        # dense table of live-row indices via one packed 1-op sort (the
        # engine's scatter-free design; see ops/merge.py)
        from ..ops.merge import flagged_positions

        gather_idx = jnp.maximum(flagged_positions(mask, n), 0)
        out = self.take(gather_idx)
        live = jnp.arange(n, dtype=jnp.int32) < count
        # compaction is order-preserving over live rows: clustering survives
        out = dataclasses.replace(out, clustered_by=self.clustered_by)
        return out.with_sel(live)

    # -- host conversion --
    def to_pylists(self) -> Dict[str, list]:
        """Decode live rows to python lists (host sync; tests/output only)."""
        sel = None if self.sel is None else np.asarray(self.sel)
        return {n: c.to_pylist(sel) for n, c in zip(self.names, self.columns)}


__all__ = ["Column", "Block", "column_from_numpy"]
