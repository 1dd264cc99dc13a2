"""Fused scan -> filter -> project -> aggregate: one Pallas kernel (Triton).

Role analog: the reference's ``Aggregator`` executing key-specialized
methods (``Interpreters/Aggregator.h:442``) over blocks its scan has
already filtered (``DMFilePackFilter``) — here the whole chain is one
kernel, so no filtered or projected column ever goes back to device memory.

Plain XLA runs such a chain (TPC-H Q1, Q6) as the masked method of
``ops/aggregate.py``: it writes the slot masks and the projected values to
device memory and reads them back, several passes over the table.  This
module takes the chain as a function of one tile of the scanned columns
(the plan compiler builds it from Selection/Projection nodes) and covers
sum/count/avg over integer or decimal values when the keys pack into few
slots:

- one program per ``CHUNK_ROWS`` rows loads the scanned columns once,
  evaluates the chain (plain ``jax.numpy`` inside the kernel), packs the
  keys into a slot id, and adds every (slot, lane) value into per-thread
  registers; a lane is one value or count the aggregates need;
- it writes one int64 partial per (slot, lane) to a (tiles, slots x lanes)
  array, with no carry between programs; XLA sums the partials over tiles;
- the plain path's own pieces build the result from those sums: the
  wide-decimal rewrite (``_wide_rewrite``, whose int64 exactness proof
  covers the whole input, so every partial and total is exact), the
  result columns (``additive_result``) and the key columns.

On a GPU the kernel compiles through Triton; elsewhere the plain path
runs.  Tests run the kernel on the CPU in Pallas' interpreter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.block import Block, Column
from ..core.dtypes import INT64
from .aggregate import (
    AggDesc, AggregateResult, _wide_rewrite, additive_result,
    pack_keys_direct, unpack_keys_direct,
)

# rows per program, and warps per program (each thread takes one row per
# loop step)
CHUNK_ROWS = 32768
NUM_WARPS = 4
# int64 accumulators each thread keeps (slots x lanes): TPC-H Q1's at
# SF10, 6 x 9 (two of its sums split into two digit lanes each), the
# largest chain timed on the card.  Larger chains take the plain path
# until a run shows the kernel still wins there (registers spill).
MAX_ACCUMULATORS = 54

TileChain = Callable[[Dict[str, Column], jnp.ndarray], Block]
Lane = Tuple[str, Optional[str], Optional[str]]  # (kind, arg, filter)


def kernel_route() -> Optional[str]:
    """'triton' on a GPU, else None (the plain path)."""
    return "triton" if jax.default_backend() == "gpu" else None


def _lanes(aggs: Sequence[AggDesc], block: Block) -> List[Lane]:
    """Lane 0 counts live rows; then one count lane per (arg, filter) that
    can differ from it, and one sum lane per (arg, filter) summed."""
    lanes: List[Lane] = [("count", None, None)]
    for a in aggs:
        ck = _count_lane(a, block)
        if ck not in lanes:
            lanes.append(ck)
        if a.func != "count" and ("sum", a.arg, a.filter_col) not in lanes:
            lanes.append(("sum", a.arg, a.filter_col))
    return lanes


def _count_lane(a: AggDesc, block: Block) -> Lane:
    if a.filter_col is None and (a.arg is None
                                 or block[a.arg].validity is None):
        return ("count", None, None)
    return ("count", a.arg, a.filter_col)


def _lane_values(lane: Lane, block: Block) -> jnp.ndarray:
    kind, arg, filt = lane
    m = None
    if filt is not None:
        f = block[filt]
        m = f.data.astype(jnp.bool_)
        if f.validity is not None:
            m = m & f.validity
    if arg is not None and block[arg].validity is not None:
        m = block[arg].validity if m is None else (m & block[arg].validity)
    if kind == "count":
        one = jnp.ones(block.capacity, jnp.int64)
        return one if m is None else m.astype(jnp.int64)
    v = block[arg].data.astype(jnp.int64)
    return v if m is None else jnp.where(m, v, 0)


def _eligible(block: Block, keys, aggs: Sequence[AggDesc]) -> bool:
    for a in aggs:
        if a.func not in ("sum", "count", "avg"):
            return False
        if a.arg is not None:
            c = block[a.arg]
            if c.data.ndim != 1 or c.dtype.is_float \
                    or not jnp.issubdtype(c.data.dtype, jnp.integer):
                return False
    return all(block[k].data.ndim == 1 for k in keys)


def fused_aggregate(cols: Dict[str, Column], chain: TileChain, block: Block,
                    keys: Sequence[str], aggs: Sequence[AggDesc],
                    interpret: bool = False) -> Optional[AggregateResult]:
    """``aggs`` grouped by ``keys`` over the live rows of ``chain``, through
    the kernel; None when the chain does not qualify.

    ``cols`` are the scanned columns: 1-D, NULL-free, all of one length.
    ``chain(tile_columns, in_bounds)`` evaluates the filters and
    projections on one tile of them, inside the kernel.  ``block`` is the
    same chain over every row; only its static shape is read (types,
    dictionaries, value ranges), so XLA drops its operations."""
    n = block.capacity
    rw = _wide_rewrite(block, aggs, rows=n)
    block, aggs2, post = (block, list(aggs), None) if rw is None else rw
    if not _eligible(block, keys, aggs2):
        return None
    domain = 1
    if keys:
        packed = pack_keys_direct([block[k] for k in keys])
        if packed is None:
            return None
        domain = packed[1]
    lanes = _lanes(aggs2, block)
    if domain * len(lanes) > MAX_ACCUMULATORS:
        return None

    def tile_fn(tile: Dict[str, Column], inb: jnp.ndarray):
        blk = chain(tile, inb)
        trw = _wide_rewrite(blk, aggs, rows=n)
        if trw is not None:
            blk = trw[0]
        slot = (pack_keys_direct([blk[k] for k in keys])[0] if keys
                else jnp.zeros(blk.capacity, jnp.int32))
        return slot, blk.sel_mask(), [_lane_values(ln, blk) for ln in lanes]

    if not _lowers(cols, n, tile_fn, domain, len(lanes)):
        return None
    totals = _tile_lane_sums(cols, n, tile_fn, domain, len(lanes), interpret)

    def lane(key: Lane) -> jnp.ndarray:
        return totals[:, lanes.index(key)]

    acc = []
    for a in aggs2:
        cnts = lane(_count_lane(a, block))
        if a.func == "count":
            acc.append((a.name, Column(cnts, None, INT64)))
        else:
            acc.append((a.name, additive_result(
                a, block[a.arg], lane(("sum", a.arg, a.filter_col)), cnts)))
    occupied = lane(("count", None, None)) > 0
    key_cols = unpack_keys_direct(jnp.arange(domain, dtype=jnp.int32),
                                  [block[k] for k in keys]) if keys else []
    out = Block(names=tuple(keys) + tuple(nm for nm, _ in acc),
                columns=tuple(key_cols) + tuple(c for _, c in acc),
                sel=occupied if keys else None)
    if post is not None:
        out = post(out)
    groups = jnp.sum(occupied, dtype=jnp.int32) if keys else jnp.int32(1)
    return AggregateResult(out, groups, jnp.int64(0))


def _lowers(cols: Dict[str, Column], n: int, tile_fn, domain: int,
            n_lanes: int) -> bool:
    """Whether the kernel over ``tile_fn`` lowers through Triton: Pallas
    refuses a kernel that closes over an array (a dictionary lookup table,
    say), and the Triton lowering an operation it has no rule for.  Tried
    for the GPU on any backend, so CPU tests check it too."""

    def run(*arrays):
        tile = {c: dataclasses.replace(cols[c], data=a)
                for c, a in zip(cols, arrays)}
        return _tile_lane_sums(tile, n, tile_fn, domain, n_lanes, False)

    args = [jax.ShapeDtypeStruct(c.data.shape, c.data.dtype)
            for c in cols.values()]
    try:
        jax.jit(run).trace(*args).lower(lowering_platforms=("cuda",))
    except (NotImplementedError, TypeError, ValueError):
        return False
    return True


def _tile_lane_sums(cols: Dict[str, Column], n: int, tile_fn, domain: int,
                    n_lanes: int, interpret: bool) -> jnp.ndarray:
    """(domain, n_lanes) int64 sums over live rows of each slot.

    ``tile_fn(tile_columns, in_bounds) -> (slot, live, lanes)`` maps one
    tile of the scanned columns to its rows' slot ids, live mask and lane
    values; it runs inside the kernel.  Each program walks CHUNK_ROWS rows
    in steps of one row per thread, adding every (slot, lane) value into a
    per-thread accumulator, and reduces across its threads once at the
    end."""
    step = 32 * NUM_WARPS
    steps = CHUNK_ROWS // step
    T = pl.cdiv(n, CHUNK_ROWS)
    K = domain * n_lanes
    K_pad = max(16, pl.next_power_of_2(K))
    names = list(cols)

    def kernel(*refs):
        out_ref = refs[-1]
        base = pl.program_id(0) * CHUNK_ROWS
        iota = jax.lax.broadcasted_iota(jnp.int32, (step,), 0)

        def body(j, accs):
            start = base + j * step
            inb = start + iota < n
            tile = {c: dataclasses.replace(cols[c], data=plgpu.load(
                        refs[i].at[pl.ds(start, step)], mask=inb, other=0))
                    for i, c in enumerate(names)}
            slot, live, lanes = tile_fn(tile, inb)
            live = live & inb
            out = []
            for s in range(domain):
                hit = live & (slot == s)
                out.extend(acc + jnp.where(hit, v, 0)
                           for acc, v in zip(accs[s * n_lanes:], lanes))
            return tuple(out)

        accs = jax.lax.fori_loop(
            0, steps, body,
            tuple(jnp.zeros((step,), jnp.int64) for _ in range(K)))
        k_iota = jax.lax.broadcasted_iota(jnp.int32, (K_pad,), 0)
        vec = jnp.zeros((K_pad,), jnp.int64)
        for k, acc in enumerate(accs):
            vec = jnp.where(k_iota == k, jnp.sum(acc), vec)
        out_ref[...] = vec[None, :]

    partials = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((T, K_pad), jnp.int64),
        grid=(T,),
        out_specs=pl.BlockSpec((1, K_pad), lambda i: (i, 0)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="fused_scan_aggregate",
    )(*[cols[c].data for c in names])
    return jnp.sum(partials, axis=0)[:K].reshape(domain, n_lanes)


__all__ = ["fused_aggregate", "kernel_route", "CHUNK_ROWS",
           "MAX_ACCUMULATORS"]
