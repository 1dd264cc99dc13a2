"""Out-of-core execution: aggregation chunking, grace hash join, external
sort.

Role analog: the reference's spill-to-disk machinery
(``Core/Spiller.h:87``, agg spill + ``MergingBuckets`` restore, join
restore rounds ``Interpreters/Join.h:95-100``, sort spill
``Interpreters/SortSpillContext.h``).  The inversion: instead of
spilling state OUT of memory mid-query, never let the working set exceed
device memory — the host (whose RAM is the spill tier) splits the inputs and the
device runs one compiled program per piece:

- **chunked aggregation** (``run_chunked_aggregate``): row-slice the base
  table, partial-aggregate per chunk, merge partial states.
- **grace hash join** (``run_grace_join``): hash-partition the big
  side(s) by join key on the host, run the FULL plan per partition
  (co-partitioned or replicated-build), then re-apply the reducing
  wrappers (TopN/Sort/Limit) over the concatenated partials — the
  restore-round analog with partitions instead of spilled files.
- **external sort** (``run_sliced``): row-slice, per-chunk sort/topN
  runs, final merge pass over the concatenated runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp

from ..core.block import Block, Column
from ..exchange.skew import concat_blocks
from ..plan import nodes as P
from ..plan.compiler import compile_fragment


def _check_flags(flags: Dict, what: str) -> None:
    """Raise runtime-eval errors, then treat any remaining positive flag
    as a capacity overflow (out-of-core paths size partitions up front —
    an overflow here is a bug, not a retry signal)."""
    import numpy as np

    from .errors import raise_runtime_errors, split_runtime_errors

    overflows, rterrs = split_runtime_errors(flags)
    raise_runtime_errors(rterrs)
    for k, v in overflows.items():
        if int(np.asarray(v).max()) > 0:
            raise RuntimeError(f"{what} overflow at {k}")


def _scan_tables(node: P.PlanNode) -> List[str]:
    if isinstance(node, P.TableScan):
        return [node.table]
    out: List[str] = []
    for c in node.children:
        out.extend(_scan_tables(c))
    return out


def _has_join(node: P.PlanNode) -> bool:
    if isinstance(node, (P.Join, P.CrossJoin, P.SkewShuffleJoin)):
        return True
    return any(_has_join(c) for c in node.children)


def chunkable(plan: P.PlanNode) -> bool:
    """True when the plan is a root Aggregation whose input pipeline reads
    exactly one table (with NO join — a self-join reads 'one table' but
    row-slicing would slice both sides) and every aggregate decomposes."""
    if not isinstance(plan, P.Aggregation):
        return False
    if any(a.func not in ("sum", "count", "avg", "min", "max", "first")
           for a in plan.aggs):
        return False
    if _has_join(plan.child):
        return False
    return len(set(_scan_tables(plan.child))) == 1


def _slice_block(block: Block, start: int, rows: int) -> Block:
    cols = tuple(
        Column(
            jnp.asarray(c.data[start:start + rows]),
            None if c.validity is None else jnp.asarray(c.validity[start:start + rows]),
            c.dtype,
            c.dictionary,
            stats=c.stats,  # a row slice keeps the range invariant
        )
        for c in block.columns
    )
    sel = None if block.sel is None else jnp.asarray(block.sel[start:start + rows])
    return Block(names=block.names, columns=cols, sel=sel)


def run_chunked_aggregate(
    plan: P.Aggregation,
    tables: Dict[str, Block],
    chunk_rows: int,
) -> Block:
    """Execute ``plan`` without ever staging more than ``chunk_rows`` of
    the base table (plus partial states) on device."""
    from .distribute_helpers import build_partial_final  # lazy import (below)

    partial_plan, final_plan_builder = build_partial_final(plan)
    # a chunk holds at most chunk_rows distinct keys: shrink the chunk
    # program's hash capacity accordingly.  autosize sizes num_slots for
    # the WHOLE table's NDV (15M slots of accumulator planes at SF10's
    # l_orderkey group-by) — paying that per chunk is what the chunking
    # exists to avoid, and on a real chip it exhausts HBM
    if isinstance(partial_plan, P.Aggregation) and partial_plan.num_slots:
        cap = 1 << (2 * chunk_rows - 1).bit_length()
        partial_plan.num_slots = min(partial_plan.num_slots, cap)
    table_name = _scan_tables(plan.child)[0]
    base = tables[table_name]
    n = base.capacity
    # pad chunks to a uniform size so every chunk reuses one compilation
    fn = compile_fragment(partial_plan)
    from .cancel import checkpoint

    from .metrics import METRICS

    partials: List = []
    start = 0
    while start < n:
        checkpoint()  # cancellable between chunks
        METRICS.counter("ooc_chunks_total").inc()
        rows = min(chunk_rows, n - start)
        chunk = _slice_block(base, start, rows)
        if rows < chunk_rows:
            pad = chunk_rows - rows
            filler = _slice_block(base, 0, pad).and_sel(
                jnp.zeros(pad, dtype=jnp.bool_)
            )
            chunk = concat_blocks(chunk, filler)
        sub = dict(tables)
        sub[table_name] = chunk
        out, overflows = fn(sub)
        _check_flags(overflows, "chunked aggregate")
        # TRUE host offload, sliced to live rows (host RAM is this
        # path's spill tier): the former jnp copy kept every partial —
        # at its full slot capacity — pinned in HBM, and the merge
        # concatenated N x num_slots rows (found by the SF10 on-chip
        # rehearsal: RESOURCE_EXHAUSTED)
        partials.append(_to_host_rows(out))
        start += rows

    total_partial_rows = sum(p[2] for p in partials)
    if total_partial_rows <= _FINAL_MERGE_ROWS:
        merged = _concat_host_parts(partials)
        final_plan = final_plan_builder()
        ffn = compile_fragment(final_plan)
        out, overflows = ffn({"__partials": merged})
        _check_flags(overflows, "chunked final")
        return out
    return _bucketed_final_merge(plan, final_plan_builder, partials)


# ---------------------------------------------------------------------------
# grace hash join (join spill / restore-round analog)
# ---------------------------------------------------------------------------

# top-level join kinds that partition cleanly by key hash (NULL-aware
# kinds need the whole build side for NULL probe keys; cross has no keys)
_GRACE_KINDS = {"inner", "left", "semi", "anti", "left_outer_semi",
                "right_outer", "full_outer"}
# kinds with no build-side tail: safe with a replicated (unpartitioned)
# build side
_NO_BUILD_TAIL = {"inner", "left", "semi", "anti", "left_outer_semi"}


def _resolve_key_base(node: P.PlanNode, key: str):
    """Trace a join-key column through a pipeline to its base-table
    column: returns (table, base_col) or None.  Pipelines may contain
    Selection/Projection (plain renames), Aggregation whose keys include
    the tracked key (groups are then partition-local), and nested Joins
    (descend the probe side; the build side is replicated whole)."""
    from ..expr.nodes import ColumnRef

    if isinstance(node, P.TableScan):
        return (node.table, key)
    if isinstance(node, (P.Selection, P.RuntimeFilterApply)):
        return _resolve_key_base(node.child, key)
    if isinstance(node, P.Projection):
        e = node.exprs.get(key)
        if not isinstance(e, ColumnRef):
            return None
        return _resolve_key_base(node.child, e.name)
    if isinstance(node, P.Aggregation):
        if key not in node.keys:
            return None
        return _resolve_key_base(node.child, key)
    if isinstance(node, P.Join):
        r = _resolve_key_base(node.probe, key)
        if r is not None:
            return r
        # build-side columns appear in the output only for kinds without
        # NULL extension of duplicated replicated-probe rows
        if node.kind == "inner":
            return _resolve_key_base(node.build, key)
        return None
    return None


def grace_spec(plan: P.PlanNode):
    """Match ``[TopN|Sort|Limit|Projection|Selection|Aggregation]* Join``
    where both join sides resolve their keys to base-table columns.
    Returns a dict spec or None."""
    wrappers = []
    node = plan
    while isinstance(node, (P.TopN, P.Sort, P.Limit, P.Projection,
                            P.Selection, P.Aggregation)):
        wrappers.append(node)
        node = node.child
    if not isinstance(node, P.Join) or node.kind not in _GRACE_KINDS:
        return None
    key_names = set(node.probe_keys) | set(node.build_keys)
    for w in wrappers:
        if isinstance(w, P.Aggregation) and not (set(w.keys) & key_names):
            return None  # groups would span partitions
    probe_base = [_resolve_key_base(node.probe, k) for k in node.probe_keys]
    build_base = [_resolve_key_base(node.build, k) for k in node.build_keys]
    if any(b is None for b in probe_base + build_base):
        return None
    if len({t for t, _ in probe_base}) != 1 or len({t for t, _ in build_base}) != 1:
        return None  # each side partitions exactly one base table
    pt, bt = probe_base[0][0], build_base[0][0]
    clone = None
    if pt == bt:
        # self-join / shared scan: the two sides partition the SAME base
        # table independently (probe by probe keys, build by build keys
        # — value-based hashing co-partitions equal keys), so the build
        # subtree re-reads it under a cloned name (reference: the
        # restore-round Join spills each side separately,
        # Interpreters/Join.h:95-100)
        clone = bt + "__grace_build"
        bt = clone
    return {
        "wrappers": wrappers,
        "join": node,
        "probe_table": pt,
        "probe_cols": [c for _, c in probe_base],
        "build_table": bt,
        "build_cols": [c for _, c in build_base],
        "clone_build_scan": clone,
    }


def _clone_scan(node: P.PlanNode, old: str, new: str) -> P.PlanNode:
    """Copy a subtree with TableScan(old) renamed to TableScan(new)."""
    if isinstance(node, P.TableScan):
        if node.table == old:
            return P.TableScan(new, columns=node.columns)
        return node
    import copy

    n2 = copy.copy(node)
    kids = tuple(_clone_scan(c, old, new) for c in node.children)
    n2.children = kids
    if hasattr(n2, "child") and len(kids) == 1:
        n2.child = kids[0]
    if hasattr(n2, "probe") and len(kids) == 2:
        n2.probe, n2.build = kids
    return n2


def _hash_host_triples(triples, n: int) -> "object":
    """Splitmix64 over host (data, validity, dictionary) column triples —
    the shared core of `_host_key_hash` and the bucketed final merge."""
    import zlib

    import numpy as np

    h = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    for data, validity, dictionary in triples:
        data = np.asarray(data)
        if dictionary is not None:
            lut = np.fromiter(
                (zlib.crc32(s.encode()) for s in dictionary),
                dtype=np.uint64, count=len(dictionary),
            ) if dictionary else np.zeros(1, dtype=np.uint64)
            x = lut[np.clip(data, 0, max(len(lut) - 1, 0))]
        else:
            x = data.astype(np.int64).view(np.uint64)
            if x.ndim > 1:
                # multi-plane key column (wide-decimal limbs): XOR-fold
                # the planes into one lane — equal values have equal limb
                # tuples, so the fold preserves co-partitioning
                x = np.bitwise_xor.reduce(x, axis=tuple(range(1, x.ndim)))
        if validity is not None:
            v = np.asarray(validity)
            if v.ndim > 1:
                v = v.all(axis=tuple(range(1, v.ndim)))
            x = np.where(v, x, np.uint64(0))
        # splitmix64 finalizer
        z = (h ^ x) * np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        h = z ^ (z >> np.uint64(31))
    return h


def _host_key_hash(block: Block, cols: List[str]) -> "object":
    """Stable value-based uint64 hash of the key columns, on host.
    Dictionary strings hash by VALUE (not code) so co-partitioning holds
    across tables with different dictionaries."""
    return _hash_host_triples(
        ((block[name].data, block[name].validity, block[name].dictionary)
         for name in cols),
        block.capacity)


def _partition_block(block: Block, pid, P_: int, cap: int) -> List[Block]:
    """Row-select each partition into a fixed-capacity padded Block.
    Order-preserving (equal-key adjacency — clustered_by — survives)."""
    import numpy as np

    out = []
    for p in range(P_):
        idx = np.nonzero(pid == p)[0]
        n = len(idx)
        pad_idx = np.zeros(cap, dtype=np.int64)
        pad_idx[:n] = idx
        cols = []
        for c in block.columns:
            data = np.asarray(c.data)[pad_idx]
            validity = (None if c.validity is None
                        else np.asarray(c.validity)[pad_idx])
            cols.append(Column(jnp.asarray(data),
                               None if validity is None else jnp.asarray(validity),
                               c.dtype, c.dictionary, stats=c.stats))
        sel = jnp.asarray(np.arange(cap) < n)
        out.append(Block(names=block.names, columns=tuple(cols), sel=sel,
                         clustered_by=block.clustered_by))
    return out


def _to_host_rows(block: Block) -> Tuple[Tuple[str, ...], List, "object"]:
    """Compacted host copy of a device block's live rows.  Only host
    arrays + lightweight metadata survive — holding the device Column
    here would pin every partition's output in HBM for the whole
    restore loop."""
    import numpy as np

    b = block.compact()
    n = int(np.asarray(b.num_rows()))
    cols = []
    for c in b.columns:
        data = np.asarray(c.data)[:n]
        validity = None if c.validity is None else np.asarray(c.validity)[:n]
        cols.append((data, validity, (c.dtype, c.dictionary, c.stats)))
    return b.names, cols, n


def _part_store(spill_dir: str, tag: str, nthreads: int = 0):
    """PartStore staging (names, [(data, validity, meta)]) parts; with a
    spill dir the arrays live in compressed chunk files (native
    spiller), not host RAM — the Spiller restore-round analog."""
    import os

    from .spill import PartStore

    d = ""
    if spill_dir:
        d = os.path.join(spill_dir, f"{tag}-{os.getpid()}")
    # 0 passes through: the native spiller resolves it to hardware
    # concurrency (same contract as the native loader / max_threads=0)
    return PartStore(d, nthreads=nthreads)


def _store_add(store, part, partition: int) -> None:
    names, cols, _n = part
    flat: List = []
    for data, validity, _meta in cols:
        flat.append(data)
        flat.append(validity)
    store._metas = [m for _, _, m in cols]  # identical across parts
    store.add(names, flat, partition)


def _store_parts(store):
    out = []
    for names, flat in store.parts():
        cols = []
        for i, meta in enumerate(store._metas):
            cols.append((flat[2 * i], flat[2 * i + 1], meta))
        out.append((names, cols))
    return out


def _concat_host_parts(parts) -> Block:
    import numpy as np

    names = parts[0][0]
    ncols = len(parts[0][1])
    cols = []
    for i in range(ncols):
        datas = [p[1][i][0] for p in parts]
        dtype, dictionary, stats = parts[0][1][i][2]
        # range stats must cover EVERY part (downstream narrowing / LUT
        # domain decisions rely on them being sound)
        if stats is not None:
            allst = [p[1][i][2][2] for p in parts]
            if any(s is None for s in allst):
                stats = None
            else:
                stats = (min(s[0] for s in allst),
                         max(s[1] for s in allst))
        data = np.concatenate(datas) if datas else np.zeros(0)
        if any(p[1][i][1] is not None for p in parts):
            validity = np.concatenate([
                p[1][i][1] if p[1][i][1] is not None
                else np.ones(len(p[1][i][0]), dtype=bool)
                for p in parts
            ])
        else:
            validity = None
        cols.append(Column(jnp.asarray(data),
                           None if validity is None else jnp.asarray(validity),
                           dtype, dictionary, stats=stats))
    return Block(names=names, columns=tuple(cols), sel=None)


# One final-merge program's input capacity (rows of partial states).
# Above this the merge runs BUCKETED (see _bucketed_final_merge): a
# single program over N_chunks x chunk_cap partial rows with the whole
# table's num_slots is the largest program this engine ever builds — at
# SF10 (15M-group l_orderkey agg, ~60M partial rows) it crashes the AOT
# compile helper outright (SIGSEGV, observed twice) and would pin every
# partial in HBM besides.
_FINAL_MERGE_ROWS = 4 << 20


def _split_host_part(part, key_idx, P_: int):
    """Split one host partial (names, cols, n) into per-bucket host
    parts by group-key hash; yields (bucket, sub_part), empties skipped."""
    import numpy as np

    names, cols, n = part
    h = _hash_host_triples(
        ((cols[i][0], cols[i][1], cols[i][2][1]) for i in key_idx), n)
    pid = (h % np.uint64(P_)).astype(np.int64)
    for p in np.unique(pid):
        m = pid == p
        sub = [(d[m], None if v is None else v[m], meta)
               for d, v, meta in cols]
        yield int(p), (names, sub, int(m.sum()))


def _stage_host_parts_padded(parts, cap: int) -> Block:
    """Concat host parts and stage ONE device block padded to ``cap``
    rows with a live-row sel mask — uniform shapes let one compiled
    final program serve every bucket.  Pad rows REPEAT the last live row
    (``np.pad(mode="edge")``) so the columns' range stats stay sound
    unconditionally — the invariant ``_concat_host_parts`` documents —
    rather than relying on sel-deadness downstream."""
    import numpy as np

    merged = _concat_host_parts(parts)
    n = merged.capacity
    assert n <= cap, (n, cap)
    cols = []
    for c in merged.columns:
        data = np.asarray(c.data)
        pad = [(0, cap - n)] + [(0, 0)] * (data.ndim - 1)
        data = np.pad(data, pad, mode="edge" if n else "constant")
        validity = c.validity
        stats = c.stats if n else None
        if validity is not None:
            vpad = [(0, cap - n)] + [(0, 0)] * (np.asarray(validity).ndim - 1)
            validity = np.pad(np.asarray(validity), vpad,
                              mode="edge" if n else "constant")
        cols.append(Column(jnp.asarray(data),
                           None if validity is None else jnp.asarray(validity),
                           c.dtype, c.dictionary, stats=stats))
    sel = jnp.asarray(np.arange(cap) < n)
    return Block(names=merged.names, columns=tuple(cols), sel=sel)


def _bucketed_final_merge(plan: P.Aggregation, final_plan_builder,
                          partials) -> Block:
    """Merge chunked-agg partial states in GROUP-KEY-HASH buckets — the
    reference's ``MergingBuckets`` restore analog
    (``Interpreters/Aggregator.cpp:1268`` spill restore,
    ``Aggregator.h:1035``).  Hashing on the group keys keeps every group
    whole inside one bucket, so a small final program (compiled once,
    reused per bucket) is exact and bucket outputs simply concatenate.

    COMPILE-FAILURE FALLBACK LADDER: a backend compiler can fail
    deterministically on one merge-program shape (seen at SF10 on an
    earlier accelerator's compiler: three identical failures on the same
    program), so re-running the same program is not a strategy.  Each rung
    changes the program SHAPE, and the last rung leaves the compiler out
    entirely:

    1. agg core + post-projection as SEPARATE programs at the natural
       bucket count (two simple shapes instead of one fused one);
    2. 4x the bucket count (smaller uniform shapes);
    3. host-side numpy merge (``_host_final_merge``) — correctness
       first; the reference restores spilled buckets on the CPU too.
    """
    import jax

    from .failpoint import FailPointError
    from .logging import get_logger

    total = sum(p[2] for p in partials)
    P_ = 1
    while total // P_ > _FINAL_MERGE_ROWS and P_ < 1024:
        P_ *= 2
    names = partials[0][0]
    key_idx = [names.index(k) for k in plan.keys]
    from .metrics import METRICS

    log = get_logger("tiflash_jax.outofcore")
    METRICS.counter("ooc_final_merges_total").inc()
    for p_try in dict.fromkeys((P_, min(P_ * 4, 4096))):
        try:
            return _device_bucket_merge(
                final_plan_builder, partials, key_idx, p_try)
        except (jax.errors.JaxRuntimeError, FailPointError) as e:
            # backend/compile-service failure (or its fault-injection
            # twin, failpoint ``compile_failure_in_final_merge``) — not
            # an engine error; step down the ladder
            METRICS.counter("ooc_compile_fallbacks_total").inc()
            first = str(e).splitlines()[0] if str(e) else repr(e)
            log.warning(
                "bucketed final merge at %d buckets failed in the "
                "backend (%s); stepping down the fallback ladder",
                p_try, first)
    METRICS.counter("ooc_host_merges_total").inc()
    log.warning("bucketed final merge: device programs failed to "
                "compile; falling back to the host-side merge")
    return _host_final_merge(plan, final_plan_builder, partials)


def _device_bucket_merge(final_plan_builder, partials, key_idx,
                         P_: int) -> Block:
    """One device-side bucketed-merge attempt at ``P_`` buckets.  The
    agg core and any post-projection (avg division etc.) compile as
    separate programs.  Raises ``jax.errors.JaxRuntimeError`` through to
    the fallback ladder when the backend rejects a program."""
    import copy

    from .cancel import checkpoint
    from .failpoint import fail_point
    from .logging import get_logger

    fail_point("compile_failure_in_final_merge")
    buckets: List[List] = [[] for _ in range(P_)]
    for part in partials:
        for p, sub in _split_host_part(part, key_idx, P_):
            buckets[p].append(sub)
    rows = [sum(s[2] for s in b) for b in buckets]
    if max(rows) > _FINAL_MERGE_ROWS:
        # name the failure mode (skewed key hash, or the P_ cap) instead
        # of letting it resurface as a compiler crash on an oversized
        # program
        get_logger("tiflash_jax.outofcore").warning(
            "bucketed final merge: largest bucket holds %d partial rows,"
            " above the %d-row program budget at %d buckets — compiling"
            " an oversized merge program", max(rows), _FINAL_MERGE_ROWS,
            P_)
    cap = int(-(-max(max(rows), 1) // 8192) * 8192)

    final_plan = final_plan_builder()
    wrappers: List[P.PlanNode] = []
    agg = final_plan
    while not isinstance(agg, P.Aggregation):
        wrappers.append(agg)
        agg = agg.child
    if agg.num_slots:
        # a bucket holds <= cap group rows — same shrink rule as the
        # per-chunk partial program
        agg.num_slots = min(agg.num_slots, 1 << (2 * cap - 1).bit_length())
    ffn = compile_fragment(agg)
    pfn = None
    if wrappers:
        node: P.PlanNode = P.TableScan("__m")
        for w in reversed(wrappers):
            w2 = copy.copy(w)
            w2.child = node
            w2.children = (node,)
            node = w2
        pfn = compile_fragment(node)

    outs = []
    for p in range(P_):
        if not buckets[p]:
            continue
        checkpoint()  # cancellable between buckets
        out, overflows = ffn(
            {"__partials": _stage_host_parts_padded(buckets[p], cap)})
        _check_flags(overflows, "chunked final bucket")
        if pfn is not None:
            out, overflows = pfn({"__m": out})
            _check_flags(overflows, "chunked final bucket post")
        outs.append(_to_host_rows(out))
    return _concat_host_parts(outs)


def _host_final_merge(plan: P.Aggregation, final_plan_builder,
                      partials) -> Block:
    """Last ladder rung: merge the partial states entirely on the host
    with numpy — one stable lexsort by group key, segment reductions per
    aggregate.  Mirrors the narrow-stored wide-decimal representation
    (wide result TYPE over 1-D int64 data, exactness checked against a
    64-bit-mantissa ``longdouble`` shadow sum); any post-projection
    re-applies through the engine's own compiled elementwise program in
    uniform slices, so division/rounding semantics stay the engine's."""
    import numpy as np

    from ..ops.aggregate import agg_result_dtype

    names = list(partials[0][0])
    ncols = len(names)
    datas, valids = [], []
    for i in range(ncols):
        datas.append(np.concatenate([p[1][i][0] for p in partials]))
        if any(p[1][i][1] is not None for p in partials):
            valids.append(np.concatenate([
                p[1][i][1] if p[1][i][1] is not None
                else np.ones(len(p[1][i][0]), dtype=bool)
                for p in partials]))
        else:
            valids.append(None)
    metas = [partials[0][1][i][2] for i in range(ncols)]

    final_plan = final_plan_builder()
    wrappers: List[P.PlanNode] = []
    agg = final_plan
    while not isinstance(agg, P.Aggregation):
        wrappers.append(agg)
        agg = agg.child

    key_idx = [names.index(k) for k in agg.keys]
    used = key_idx + [names.index(a.arg) for a in agg.aggs
                      if a.arg is not None]
    for i in used:
        if datas[i].ndim != 1:
            raise NotImplementedError(
                "host final merge over a multi-plane (wide-limb) partial"
                f" column {names[i]!r} — the device ladder rungs are the"
                " only exact merge for this shape")

    n = len(datas[0]) if datas else 0
    sort_keys = []
    for i in key_idx:
        sort_keys.append(datas[i])
        if valids[i] is not None:
            sort_keys.append(valids[i])
    if n:
        order = np.lexsort(sort_keys[::-1]) if sort_keys \
            else np.arange(n, dtype=np.int64)
        diff = np.zeros(n, dtype=bool)
        diff[0] = True
        for arr in sort_keys:
            a = arr[order]
            diff[1:] |= a[1:] != a[:-1]
        starts = np.nonzero(diff)[0]
    else:
        order = np.arange(0, dtype=np.int64)
        starts = np.zeros(0, dtype=np.int64)
    g = len(starts)

    out_names: List[str] = []
    out_cols: List = []
    for k, i in zip(agg.keys, key_idx):
        out_names.append(k)
        kd = datas[i][order][starts]
        kv = None if valids[i] is None else valids[i][order][starts]
        out_cols.append((kd, kv, metas[i]))
    i64max = np.longdouble(2) ** 63
    for a in agg.aggs:
        ai = names.index(a.arg)
        d = datas[ai][order]
        v = None if valids[ai] is None else valids[ai][order]
        dtype, dictionary, _stats = metas[ai]
        rdt = agg_result_dtype(a.func, dtype)
        ov = None if v is None else (
            np.add.reduceat(v.astype(np.int64), starts) > 0 if g else
            np.zeros(0, dtype=bool))
        if a.func == "sum":
            contrib = np.where(v, d, d.dtype.type(0)) if v is not None else d
            s = np.add.reduceat(contrib, starts) if g else contrib[:0]
            if np.issubdtype(d.dtype, np.integer) and g:
                shadow = np.add.reduceat(
                    contrib.astype(np.longdouble), starts)
                if np.any(np.abs(shadow) >= i64max):
                    raise RuntimeError(
                        "host final merge: int64 sum overflow")
            out = s
        elif a.func in ("min", "max"):
            if np.issubdtype(d.dtype, np.floating):
                ident = np.inf if a.func == "min" else -np.inf
            else:
                info = np.iinfo(d.dtype)
                ident = info.max if a.func == "min" else info.min
            contrib = np.where(v, d, d.dtype.type(ident)) \
                if v is not None else d
            red = np.minimum if a.func == "min" else np.maximum
            out = red.reduceat(contrib, starts) if g else contrib[:0]
        elif a.func == "first":
            # lexsort is stable: within a group the chunk order
            # survives, so "first" picks the same partial the device
            # merge would
            out = d[starts]
            ov = None if v is None else v[starts]
        else:
            raise NotImplementedError(f"host final merge of {a.func}")
        if rdt.nullable and ov is None:
            ov = np.ones(g, dtype=bool)
        out_names.append(a.name)
        # stats are recomputed, not inherited: a merged sum can exceed
        # every partial's range
        out_cols.append((out, ov, (rdt, dictionary, None)))

    merged = (tuple(out_names), out_cols, g)
    if not wrappers:
        return _concat_host_parts([merged])

    import copy

    node: P.PlanNode = P.TableScan("__m")
    for w in reversed(wrappers):
        w2 = copy.copy(w)
        w2.child = node
        w2.children = (node,)
        node = w2
    pfn = compile_fragment(node)
    rows_per = min(max(g, 1), _FINAL_MERGE_ROWS)
    cap = int(-(-rows_per // 8192) * 8192) or 8192
    outs = []
    start = 0
    while start < g or (g == 0 and start == 0):
        rows = min(rows_per, g - start) if g else 0
        sl = (merged[0],
              [(d[start:start + rows],
                None if v is None else v[start:start + rows], m)
               for d, v, m in merged[1]],
              rows)
        out, overflows = pfn({"__m": _stage_host_parts_padded([sl], cap)})
        _check_flags(overflows, "host final merge post")
        outs.append(_to_host_rows(out))
        start += rows
        if g == 0:
            break
    return _concat_host_parts(outs)


def _reapply_reducers(wrappers, merged: Block) -> Block:
    """Re-run the reducing wrappers (outermost last) over concatenated
    partition outputs.  Projection/Selection already ran per partition;
    a partition-local Aggregation needs no re-merge (groups are disjoint
    across partitions by construction)."""
    for w in reversed(wrappers):
        if isinstance(w, P.TopN):
            mini = P.TopN(w.sort_keys, w.limit, P.TableScan("__oc"))
        elif isinstance(w, P.Sort):
            mini = P.Sort(w.sort_keys, P.TableScan("__oc"))
        elif isinstance(w, P.Limit):
            mini = P.Limit(w.limit, P.TableScan("__oc"))
        else:
            continue
        out, overflows = compile_fragment(mini)({"__oc": merged})
        _check_flags(overflows, "out-of-core merge")
        merged = out.compact()
    return merged


def run_grace_join(
    plan: P.PlanNode,
    tables: Dict[str, Block],
    budget_bytes: int,
    spill_dir: str = "",
    nthreads: int = 0,
    mesh=None,
) -> Block:
    """Execute a join-rooted plan whose inputs exceed the device budget.

    Host hash-partitions the keyed base table(s); each partition runs the
    FULL per-partition plan (one compilation, fixed padded capacity);
    partition outputs spill to host and the reducing wrappers merge them.
    When the build side fits in the budget it is replicated whole
    (broadcast-grace); otherwise both sides co-partition (classic grace).

    With a ``mesh``, every partition's plan runs DISTRIBUTED across the
    devices (hash exchanges inside each grace partition — the config-5
    composition: out-of-core x multi-chip; the reference's compute-server
    spill tests compose the same way,
    ``Flash/tests/gtest_compute_server.cpp``).  ``budget_bytes`` is then
    the per-partition AGGREGATE budget across devices.
    """
    from ..runtime.memory import block_bytes

    spec = grace_spec(plan)
    assert spec is not None, "run_grace_join on a non-graceable plan"
    clone = spec.get("clone_build_scan")
    if clone is not None:
        # rebuild the plan with the build subtree scanning the cloned
        # name, and register the shared table under it
        join = spec["join"]
        new_join = P.Join(
            kind=join.kind, probe_keys=list(join.probe_keys),
            build_keys=list(join.build_keys), probe=join.probe,
            build=_clone_scan(join.build, clone[: -len("__grace_build")],
                              clone),
            unique_build=join.unique_build,
            output_capacity=join.output_capacity)
        node = new_join
        for w in reversed(spec["wrappers"]):
            import copy as _copy

            w2 = _copy.copy(w)
            w2.child = node
            w2.children = (node,)
            node = w2
        plan = node
        tables = dict(tables)
        tables[clone] = tables[clone[: -len("__grace_build")]]
        spec = dict(spec, join=new_join)
    probe_b = tables[spec["probe_table"]]
    build_b = tables[spec["build_table"]]
    big = block_bytes(probe_b) + block_bytes(build_b)
    P_ = 1
    while big // P_ > max(budget_bytes // 4, 1):
        P_ *= 2
    P_ = min(P_, 256)

    import numpy as np

    hp = _host_key_hash(probe_b, spec["probe_cols"])
    # adaptive re-split (the restore-round analog, but host hashing is
    # free so recursion collapses into widening P_): when the LARGEST
    # partition still exceeds its share — hash collisions or moderate
    # key skew — double the partition count.  Identical-key skew is
    # irreducible and surfaces as a capacity overflow downstream.
    row_bytes = max(1, big // max(probe_b.capacity + build_b.capacity, 1))
    while P_ < 4096:
        counts = np.bincount((hp % np.uint64(P_)).astype(np.int64),
                             minlength=P_)
        if int(counts.max()) * row_bytes * 4 <= budget_bytes or \
                int(counts.max()) <= 8192:
            break
        P_ *= 2
    pid_probe = (hp % np.uint64(P_)).astype(np.int64)
    counts = np.bincount(pid_probe, minlength=P_)
    cap_p = int(-(-(counts.max()) // 8192) * 8192) or 8192
    probe_parts = _partition_block(probe_b, pid_probe, P_, cap_p)

    replicate_build = (
        spec["join"].kind in _NO_BUILD_TAIL
        and block_bytes(build_b) * 3 <= budget_bytes
    )
    if replicate_build:
        build_parts = [build_b] * P_
    else:
        if spec["join"].kind not in _GRACE_KINDS:
            raise RuntimeError("join kind not grace-partitionable")
        hb = _host_key_hash(build_b, spec["build_cols"])
        pid_build = (hb % np.uint64(P_)).astype(np.int64)
        bc = np.bincount(pid_build, minlength=P_)
        cap_b = int(-(-(bc.max()) // 8192) * 8192) or 8192
        build_parts = _partition_block(build_b, pid_build, P_, cap_b)

    if mesh is None:
        fn = compile_fragment(plan)
        shard = collect = None
    else:
        from ..mpp.runner import (collect_result, compile_distributed,
                                  shard_catalog_blocks)
        from ..plan.auto import distribute_plan

        n_dev = int(np.prod(list(mesh.shape.values())))
        stats = {name: blk.capacity for name, blk in tables.items()}
        dplan = plan
        if "Exchange" not in plan.pretty():
            dplan = distribute_plan(plan, stats, n_dev, tables=tables)
        dist_fn = compile_distributed(dplan, mesh)

        def fn(sub):
            out, ov = dist_fn(shard_catalog_blocks(sub, mesh))
            return collect_result(out), ov

    from .metrics import METRICS

    METRICS.counter("ooc_grace_joins_total").inc()
    METRICS.counter("ooc_grace_partitions_total").inc(P_)
    store = _part_store(spill_dir, "grace", nthreads)
    from .cancel import checkpoint

    try:
        for p in range(P_):
            checkpoint()
            sub = dict(tables)
            sub[spec["probe_table"]] = probe_parts[p]
            sub[spec["build_table"]] = build_parts[p]
            out, overflows = fn(sub)
            _check_flags(overflows, "grace partition")
            _store_add(store, _to_host_rows(out), p)
        merged = _concat_host_parts(_store_parts(store))
    finally:
        store.close()
    return _reapply_reducers(spec["wrappers"], merged)


# ---------------------------------------------------------------------------
# group-hash partitioned aggregation (non-decomposable aggregates)
# ---------------------------------------------------------------------------


def groupagg_spec(plan: P.PlanNode):
    """Match ``[TopN|Sort|Limit|Projection|Selection]* Aggregation`` with
    group keys resolving to one base table.  Hash-partitioning the input
    BY GROUP KEY makes every group partition-local, so ANY aggregate —
    count(distinct), group_concat, var/std, quantile — is exact per
    partition and outputs simply concatenate (reference: the agg spill
    buckets partition by key hash too, ``MergingBuckets``)."""
    wrappers = []
    node = plan
    while isinstance(node, (P.TopN, P.Sort, P.Limit, P.Projection,
                            P.Selection)):
        wrappers.append(node)
        node = node.child
    if not isinstance(node, P.Aggregation) or not node.keys:
        return None
    bases = [_resolve_key_base(node.child, k) for k in node.keys]
    if any(b is None for b in bases):
        return None
    if len({t for t, _ in bases}) != 1:
        return None
    if _has_join(node.child) or len(set(_scan_tables(node.child))) != 1:
        return None
    return {"wrappers": wrappers, "agg": node, "table": bases[0][0],
            "cols": [c for _, c in bases]}


def run_groupagg(plan: P.PlanNode, tables: Dict[str, Block],
                 budget_bytes: int, spill_dir: str = "",
                 nthreads: int = 0) -> Block:
    """Aggregation with non-decomposable aggregates over a table that
    exceeds the device budget: host hash-partitions the base table by
    GROUP KEY, each partition runs the full plan (groups are local),
    partials spill to host, the reducing wrappers re-apply at the end."""
    import numpy as np

    from ..runtime.memory import block_bytes

    spec = groupagg_spec(plan)
    assert spec is not None, "run_groupagg on a non-matching plan"
    base = tables[spec["table"]]
    big = block_bytes(base)
    P_ = 1
    while big // P_ > max(budget_bytes // 4, 1):
        P_ *= 2
    P_ = min(P_, 256)
    h = _host_key_hash(base, spec["cols"])
    row_bytes = max(1, big // max(base.capacity, 1))
    while P_ < 4096:
        counts = np.bincount((h % np.uint64(P_)).astype(np.int64),
                             minlength=P_)
        if int(counts.max()) * row_bytes * 4 <= budget_bytes or \
                int(counts.max()) <= 8192:
            break
        P_ *= 2
    pid = (h % np.uint64(P_)).astype(np.int64)
    counts = np.bincount(pid, minlength=P_)
    cap = int(-(-(counts.max()) // 8192) * 8192) or 8192
    parts = _partition_block(base, pid, P_, cap)

    fn = compile_fragment(plan)
    store = _part_store(spill_dir, "groupagg", nthreads)
    from .cancel import checkpoint

    try:
        for p in range(P_):
            checkpoint()
            sub = dict(tables)
            sub[spec["table"]] = parts[p]
            out, overflows = fn(sub)
            _check_flags(overflows, "groupagg partition")
            _store_add(store, _to_host_rows(out), p)
        merged = _concat_host_parts(_store_parts(store))
    finally:
        store.close()
    return _reapply_reducers(spec["wrappers"], merged)


# ---------------------------------------------------------------------------
# external sort / sliced execution (sort spill analog)
# ---------------------------------------------------------------------------


def sliced_spec(plan: P.PlanNode):
    """Match ``[TopN|Sort|Limit|Projection|Selection]*`` over one base
    table: row-sliced runs + a final merge pass are exact (no agg/join)."""
    wrappers = []
    node = plan
    reducing = False
    while isinstance(node, (P.TopN, P.Sort, P.Limit, P.Projection,
                            P.Selection)):
        if isinstance(node, (P.TopN, P.Sort, P.Limit)):
            reducing = True
        wrappers.append(node)
        node = node.child
    if not isinstance(node, P.TableScan) or not reducing:
        return None
    return {"wrappers": wrappers, "table": node.table}


def run_sliced(plan: P.PlanNode, tables: Dict[str, Block],
               chunk_rows: int, spill_dir: str = "",
               nthreads: int = 0) -> Block:
    """External sort/topN: per-chunk runs, host-concatenated, one merge
    pass (chunk-sorted runs re-sorted — the restore-merge analog)."""
    import numpy as np

    spec = sliced_spec(plan)
    assert spec is not None
    base = tables[spec["table"]]
    n = base.capacity
    fn = compile_fragment(plan)
    from .cancel import checkpoint

    store = _part_store(spill_dir, "sort", nthreads)
    start = 0
    run_no = 0
    try:
        while start < n:
            checkpoint()
            rows = min(chunk_rows, n - start)
            chunk = _slice_block(base, start, rows)
            if rows < chunk_rows:
                pad = chunk_rows - rows
                filler = _slice_block(base, 0, pad).and_sel(
                    jnp.zeros(pad, dtype=jnp.bool_))
                chunk = concat_blocks(chunk, filler)
            sub = dict(tables)
            sub[spec["table"]] = chunk
            out, overflows = fn(sub)
            _check_flags(overflows, "sliced run")
            _store_add(store, _to_host_rows(out), run_no)
            start += rows
            run_no += 1
        merged = _concat_host_parts(_store_parts(store))
    finally:
        store.close()
    return _reapply_reducers(spec["wrappers"], merged)


__all__ = [
    "run_chunked_aggregate", "chunkable",
    "run_grace_join", "grace_spec",
    "run_sliced", "sliced_spec",
]
