"""Multi-host execution helpers.

Role analog: the reference's multi-node MPP cluster (one TiFlash process
per node, gRPC over the network).  In JAX SPMD the same program runs in
every host process; collectives ride the cards' interconnect within a
host and the network across hosts with no engine-visible difference — the whole L8/L9 cluster
machinery reduces to ``jax.distributed.initialize`` plus a mesh over the
global device list (BASELINE.md config 5).

Usage (one process per host, same script):

    from tiflash_jax.mpp.multihost import init_multihost, global_mesh
    init_multihost(coordinator="host0:9999", num_processes=N, process_id=i)
    mesh = global_mesh()                      # all chips of all hosts
    fn = compile_distributed(plan, mesh)      # unchanged engine code

Sharding note: `shard_catalog_blocks` with a global mesh requires each
process to hold the full host table (it slices its shard); for large
tables use `shard_local_blocks` below, which builds the global array from
per-host local shards without replicating host memory.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ..core.block import Block, Column
from .runner import AXIS


def init_multihost(
    coordinator: str, num_processes: int, process_id: int, **kw
) -> None:
    """jax.distributed bootstrap (no-op when single-process)."""
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def global_mesh(axis: str = AXIS) -> Mesh:
    """One flat mesh axis over every card of every host — XLA picks the
    transport per edge."""
    return Mesh(np.array(jax.devices()), (axis,))


def shard_local_blocks(
    local_blocks: Dict[str, Block], mesh: Mesh, axis: str = AXIS
) -> Dict[str, Block]:
    """Assemble global sharded tables from per-process local shards
    (each host contributes only its own rows; no host-side replication).

    Every process must call this with equally-sized local blocks."""
    n_local_devs = len([d for d in mesh.devices.flat if d.process_index == jax.process_index()])
    sharding = NamedSharding(mesh, PSpec(axis))

    def place(arr):
        n = arr.shape[0]
        per_dev = -(-n // max(n_local_devs, 1))
        pieces = [
            jax.device_put(arr[i * per_dev:(i + 1) * per_dev], d)
            for i, d in enumerate(jax.local_devices())
        ]
        global_shape = (n * jax.process_count(),) + arr.shape[1:]
        return jax.make_array_from_single_device_arrays(
            global_shape, sharding, pieces
        )

    out = {}
    for name, b in local_blocks.items():
        cols = tuple(
            Column(
                place(c.data),
                place(c.validity) if c.validity is not None else None,
                c.dtype,
                c.dictionary,
            )
            for c in b.columns
        )
        sel = place(b.sel_mask())
        out[name] = Block(names=b.names, columns=cols, sel=sel)
    return out


def replicate_result(out: Block, mesh: Mesh) -> Block:
    """Make a (possibly cross-host-sharded) result fully addressable on
    every process: one all-gather into a replicated layout.  Required
    before ``collect_result``/``device_get`` under multi-process JAX,
    where a host can only read its own shards (the analog of the
    reference root MPPTask streaming the final result to the client)."""
    rep = NamedSharding(mesh, PSpec())
    return jax.jit(lambda b: b, out_shardings=rep)(out)


__all__ = ["init_multihost", "global_mesh", "shard_local_blocks",
           "replicate_result"]
