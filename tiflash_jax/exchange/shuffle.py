"""Exchange: hash shuffle / broadcast over the device mesh.

Role analog: the whole MPP exchange stack of the reference —
``HashPartitionWriter`` (``Flash/Mpp/HashPartitionWriter.cpp:139,206``),
``BroadcastOrPassThroughWriter``, ``MPPTunnel`` (``Flash/Mpp/MPPTunnel.h:475``)
and ``ExchangeReceiver`` (``Flash/Mpp/ExchangeReceiver.h:233``).

Re-design (SURVEY.md §5 mapping): partitions are mesh shards; the
sender/tunnel/receiver triple collapses into ONE collective inside the
jitted SPMD program:

- hash repartition  -> ``lax.ragged_all_to_all`` (or a padded
  ``lax.all_to_all``, see ``wire_mode``) over the device interconnect —
  no codec, no compression, no queues; device arrays move directly,
- broadcast         -> ``lax.all_gather``,
- passthrough       -> ``lax.all_gather`` + concat (every device sees the
  gathered stream; final single-consumer ops just run replicated).

Rows are pre-grouped by destination with one local sort; per-destination
counts travel via a tiny all-to-all; compaction happens as a side effect
(dead rows are simply not sent) — the analog of the writer's per-partition
block building (``HashBaseWriterHelper``).

All functions must be called INSIDE ``shard_map`` with ``axis_name`` bound.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.block import Block, Column
from ..ops.hashing import hash_block_keys, partition_ids


def _local_group_by_partition(
    block: Block, pids: jnp.ndarray, num_parts: int
) -> Tuple[Block, jnp.ndarray, jnp.ndarray]:
    """Stable-sort local rows by destination partition; dead rows last.

    Returns (grouped block, send_sizes (P,), input_offsets (P,))."""
    n = block.capacity
    live = block.sel_mask()
    p = jnp.where(live, pids, num_parts).astype(jnp.int32)
    sorted_p, perm = jax.lax.sort((p, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    grouped = block.take(perm)
    # per-partition counts from the sorted ids' run boundaries (the ids
    # are sorted already, so no scatter-add is needed)
    bounds = jnp.searchsorted(
        sorted_p, jnp.arange(num_parts + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    counts = bounds[1:] - bounds[:-1]
    offsets = bounds[:-1]
    return grouped, counts, offsets


def _ragged_exchange_array(
    arr: jnp.ndarray,
    out_capacity: int,
    input_offsets: jnp.ndarray,
    send_sizes: jnp.ndarray,
    output_offsets: jnp.ndarray,
    recv_sizes: jnp.ndarray,
    axis_name: str,
) -> jnp.ndarray:
    out = jnp.zeros((out_capacity,) + arr.shape[1:], dtype=arr.dtype)
    return jax.lax.ragged_all_to_all(
        arr, out, input_offsets, send_sizes, output_offsets, recv_sizes,
        axis_name=axis_name,
    )


# backends whose compiler lowers ``ragged-all-to-all`` (XLA:CPU does not)
RAGGED_BACKENDS = frozenset({"gpu"})


def wire_mode(backend: str) -> str:
    """The hash exchange's wire strategy on ``backend``: 'ragged' where the
    ragged all-to-all lowers, 'padded' everywhere else."""
    return "ragged" if backend in RAGGED_BACKENDS else "padded"


def shuffle_block(
    block: Block,
    keys: Sequence[str],
    axis_name: str,
    out_capacity: int,
    mode: str = "auto",
) -> Tuple[Block, jnp.ndarray]:
    """Hash-repartition live rows across the mesh axis.

    Two wire strategies (mode 'auto' picks per backend, ``wire_mode``):
    - 'ragged': ``lax.ragged_all_to_all`` — exact sizes, no padding waste.
    - 'padded': dense ``lax.all_to_all`` over fixed (P, C) chunks;
      overflows when any (src->dst) chunk exceeds C.

    Returns (received block with sel mask, overflow flag)."""
    if mode == "auto":
        mode = wire_mode(jax.default_backend())
    P = jax.lax.axis_size(axis_name)
    h = hash_block_keys(block, keys)
    pids = partition_ids(h, P)
    grouped, send_sizes, input_offsets = _local_group_by_partition(block, pids, P)

    # size matrix S[i, j] = rows device i sends to device j  (P x P, tiny)
    S = jax.lax.all_gather(send_sizes, axis_name)  # (P, P) on every device
    me = jax.lax.axis_index(axis_name)
    recv_sizes = S[:, me]  # what I receive from each source

    if mode == "ragged":
        # where my chunk to device j lands inside j's output buffer:
        # after all rows from sources < me
        csum = jnp.cumsum(S, axis=0) - S  # exclusive scan over sources
        output_offsets = csum[me, :]

        total_recv = jnp.sum(recv_sizes)
        # overflow reports the required capacity (0 = fits)
        overflow = jnp.where(total_recv > out_capacity, total_recv, 0).astype(jnp.int64)

        def exch(arr):
            return _ragged_exchange_array(
                arr, out_capacity, input_offsets, send_sizes, output_offsets,
                recv_sizes, axis_name,
            )

        cols = _exchange_columns_packed(grouped, exch)
        sel = jnp.arange(out_capacity, dtype=jnp.int32) < total_recv
        # ragged_all_to_all lays sources' chunks back-to-back, so live rows
        # are the prefix [0, total_recv).
        return Block(names=grouped.names, columns=tuple(cols), sel=sel), overflow

    assert mode == "padded", mode
    n = grouped.capacity
    # per (src,dst) chunk capacity; floor keeps small blocks (e.g. partial
    # agg outputs) safe even when every row hashes to one partition
    C = max(-(-out_capacity // P), min(n, 64))
    row_p = _row_pids_after_sort(send_sizes, n)
    # position of each grouped row inside its destination chunk
    pos_in_part = jnp.arange(n, dtype=jnp.int32) - jnp.take(
        input_offsets, jnp.clip(row_p, 0, P - 1)
    )
    live_send = row_p < P
    slot = jnp.where(
        live_send & (pos_in_part < C), row_p * C + pos_in_part, P * C
    )
    # required out_capacity if any chunk overflows (P * max chunk), else 0
    max_send = jnp.max(send_sizes)
    overflow_local = jnp.where(
        max_send > C, max_send.astype(jnp.int64) * P, 0
    )

    def exch(arr, fill=0):
        buf = jnp.zeros((P * C + 1,) + arr.shape[1:], dtype=arr.dtype).at[slot].set(
            arr, mode="drop"
        )[: P * C].reshape((P, C) + arr.shape[1:])
        out = jax.lax.all_to_all(buf, axis_name, split_axis=0, concat_axis=0, tiled=True)
        return out.reshape((P * C,) + arr.shape[1:])

    cols = _exchange_columns_packed(grouped, exch)
    # valid received slots: for source i, offsets < recv_sizes[i]
    off = jax.lax.broadcasted_iota(jnp.int32, (P, C), 1)
    sel = (off < recv_sizes[:, None]).reshape(P * C)
    return (
        Block(names=grouped.names, columns=tuple(cols), sel=sel),
        overflow_local,
    )


def _exchange_columns_packed(grouped: Block, exch) -> list:
    """Run one exchange per byte-width class instead of one per column:
    same-width columns (and validity bitmaps) are viewed as one (n, k)
    array, moved with a single collective, and unpacked — the wire-batching
    analog of the reference packing many columns into one MPPDataPacket."""
    from collections import defaultdict

    # keyed by (dtype, trailing shape): 2-D columns (two-limb decimals,
    # group_concat matrices) only pack with same-shaped peers
    groups = defaultdict(list)  # key -> list of (col_idx, kind, array)
    for i, c in enumerate(grouped.columns):
        groups[(str(c.data.dtype), c.data.shape[1:])].append((i, "data", c.data))
        if c.validity is not None:
            groups[("bool", c.validity.shape[1:])].append((i, "validity", c.validity))

    results: dict = {}
    for dt_key, entries in groups.items():
        if len(entries) == 1:
            i, kind, arr = entries[0]
            results[(i, kind)] = exch(arr)
            continue
        stacked = jnp.stack([arr for _, _, arr in entries], axis=1)  # (n, k)
        moved = exch(stacked)
        for j, (i, kind, _) in enumerate(entries):
            results[(i, kind)] = moved[:, j]

    cols = []
    for i, c in enumerate(grouped.columns):
        data = results[(i, "data")]
        validity = results.get((i, "validity"))
        # stats survive an exchange: values only move between devices, and
        # the (trace-time) range is identical on every shard under SPMD
        cols.append(Column(data, validity, c.dtype, c.dictionary,
                           stats=c.stats))
    return cols


def _row_pids_after_sort(send_sizes: jnp.ndarray, n: int) -> jnp.ndarray:
    """Recover each grouped row's destination from the size vector:
    rows are sorted by destination, so row r belongs to partition
    searchsorted(cumsum(sizes), r, 'right')."""
    from ..ops.merge import dense_inverse

    ends = jnp.cumsum(send_sizes)
    return dense_inverse(ends, n)


def allgather_block(block: Block, axis_name: str) -> Block:
    """Broadcast: every device gets all live rows (sel kept as mask).

    The broadcast-join build-side path (BroadcastOrPassThroughWriter)."""
    P = jax.lax.axis_size(axis_name)

    def g(arr):
        gathered = jax.lax.all_gather(arr, axis_name)  # (P, n, ...)
        return gathered.reshape((-1,) + arr.shape[1:])

    cols = tuple(
        Column(
            g(c.data),
            g(c.validity) if c.validity is not None else None,
            c.dtype,
            c.dictionary,
            stats=c.stats,
        )
        for c in block.columns
    )
    sel = g(block.sel_mask())
    return Block(names=block.names, columns=cols, sel=sel)


# passthrough == gather-to-consumer; on a mesh the cheap correct form is
# the same allgather with replicated downstream execution
broadcast_block = allgather_block


__all__ = ["shuffle_block", "allgather_block", "broadcast_block"]
