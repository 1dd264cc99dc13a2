"""Hash join without a hash table: sorted build side + vectorized range probe.

Role analog: ``Interpreters/Join.cpp`` (v1 partitioned hash join:
``insertFromBlock`` :532 / ``joinBlock`` :1977) and ``Interpreters/JoinV2/``
(compact row layout + lock-free pointer table).  Pointer-chasing tables
are replaced: the build "hash table" is a *sorted key array*
(the device analog of JoinV2's compact row layout): build = lexicographic
``lax.sort`` of the key column, probe = two ``searchsorted`` binary
searches giving each probe row its match range [lo, hi) — log2(n) gathers
instead of pointer chains.

Join kinds (reference ``ASTTableJoin::Kind`` dispatch): inner, left outer,
semi, anti, right outer (via matched-flag scatter, the
``ScanHashMapAfterProbeBlockInputStream`` analog).

Static shapes: the 1:N unique-build fast path emits probe-capacity outputs;
the general N:M path emits into a caller-provided ``output_capacity`` with
prefix-sum expansion and reports overflow (SURVEY.md §7 bounded-output
pattern).

NULL join keys never match (TiDB inner-join semantics); NULL-aware
semi/anti variants are a later milestone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block, Column
from ..core.dtypes import DataType, TypeKind


# ---------------------------------------------------------------------------
# join-key normalization: pack (possibly multi-column, cross-dictionary)
# keys from both sides into one comparable int64 array per side
# ---------------------------------------------------------------------------


def _translate_dictionary(
    col: Column, target_dict: Tuple[str, ...], absent: int = -1
) -> jnp.ndarray:
    """Re-encode string codes into another dictionary's code space.

    Host-side translation table built at trace time (both dictionaries are
    static pytree aux data); strings absent from the target dictionary map
    to ``absent`` (a code no target row carries, so never equal)."""
    src = col.dictionary or ()
    rank = {s: i for i, s in enumerate(target_dict)}
    table = np.array([rank.get(s, absent) for s in src], dtype=np.int64)
    if len(table) == 0:
        table = np.array([absent], dtype=np.int64)
    return jnp.asarray(table)[jnp.clip(col.data, 0, len(table) - 1)]


def _key_bits(dt: DataType, dict_size: int) -> int:
    if dt.is_string:
        return max(1, int(np.ceil(np.log2(dict_size + 2))))
    if dt.kind is TypeKind.BOOL:
        return 1
    return dt.physical.itemsize * 8


def normalize_join_keys(
    left_cols: Sequence[Column], right_cols: Sequence[Column]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (left_keys, left_null, right_keys, right_null) where keys are
    int64 and equal iff the original key tuples are equal.

    Strings are reconciled into the right (build) side's dictionary space.
    Multi-column keys pack by shifting; total width must fit in 63 bits
    (covers all TPC-H-style keys; a hash+verify fallback is a later
    milestone, reference: serialized-key method)."""
    assert len(left_cols) == len(right_cols)
    l_null = jnp.zeros(left_cols[0].data.shape[0], dtype=jnp.bool_)
    r_null = jnp.zeros(right_cols[0].data.shape[0], dtype=jnp.bool_)
    l_parts: List[jnp.ndarray] = []
    r_parts: List[jnp.ndarray] = []
    bits: List[int] = []
    for lc, rc in zip(left_cols, right_cols):
        if lc.dtype.is_string or rc.dtype.is_string:
            rdict = rc.dictionary or ()
            rv = rc.data.astype(jnp.int64)
            # Probe strings absent from the build dictionary are NOT NULL —
            # they are real values with no match.  Conflating them with NULL
            # breaks null-aware semantics ('x' NOT IN ('a','b') must keep
            # the row).  Map them to code len(rdict): one beyond any build
            # code, inside the _key_bits budget (log2(size+2)), unmatchable.
            lv = _translate_dictionary(lc, rdict, absent=len(rdict))
            b = _key_bits(rc.dtype, len(rdict))
        else:
            lv = lc.data.astype(jnp.int64)
            rv = rc.data.astype(jnp.int64)
            b = max(
                _key_bits(lc.dtype, 0),
                _key_bits(rc.dtype, 0),
            )
        if lc.validity is not None:
            l_null = l_null | ~lc.validity
        if rc.validity is not None:
            r_null = r_null | ~rc.validity
        l_parts.append(lv)
        r_parts.append(rv)
        bits.append(b)
    if len(l_parts) == 1:
        return l_parts[0], l_null, r_parts[0], r_null
    total = sum(bits)
    if total > 63:
        # hash+verify fallback (the serialized-key method analog): 63-bit
        # combined hash as the sort/probe key; hash_join re-verifies
        # original key equality on matched rows
        from .hashing import hash_columns_u63

        lk = hash_columns_u63(left_cols)
        rk = hash_columns_u63(right_cols)
        return lk, l_null, rk, r_null
    lk = jnp.zeros_like(l_parts[0])
    rk = jnp.zeros_like(r_parts[0])
    for lv, rv, b in zip(l_parts, r_parts, bits):
        # bias signed values into unsigned sub-ranges so packing is injective
        bias = jnp.int64(1) << (b - 1)
        lk = (lk << b) | ((lv + bias) & ((jnp.int64(1) << b) - 1))
        rk = (rk << b) | ((rv + bias) & ((jnp.int64(1) << b) - 1))
    return lk, l_null, rk, r_null


def join_keys_need_verify(
    left_cols: Sequence[Column], right_cols: Sequence[Column]
) -> bool:
    """True when normalize_join_keys falls back to hashed keys."""
    if len(left_cols) == 1:
        return False
    bits = []
    for lc, rc in zip(left_cols, right_cols):
        if lc.dtype.is_string or rc.dtype.is_string:
            bits.append(_key_bits(rc.dtype, len(rc.dictionary or ())))
        else:
            bits.append(max(_key_bits(lc.dtype, 0), _key_bits(rc.dtype, 0)))
    return sum(bits) > 63


def _keys_equal(
    probe_cols: Sequence[Column], build_cols: Sequence[Column]
) -> jnp.ndarray:
    """Row-wise true-key equality for hashed-key verification."""
    eq = None
    for pc, bc in zip(probe_cols, build_cols):
        if pc.dtype.is_string or bc.dtype.is_string:
            pv = _translate_dictionary(pc, bc.dictionary or ())
            bv = bc.data.astype(jnp.int64)
        else:
            pv = pc.data.astype(jnp.int64)
            bv = bc.data.astype(jnp.int64)
        e = pv == bv
        if pc.validity is not None:
            e = e & pc.validity
        if bc.validity is not None:
            e = e & bc.validity
        eq = e if eq is None else (eq & e)
    return eq


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JoinBuild:
    """Sorted build side (the 'hash table').  Reference:
    ``Join::insertFromBlock`` (Join.cpp:532) / JoinV2 ``buildRowFromBlock``.

    Only the KEYS are physically sorted; payload columns stay in original
    order and probes compose their sorted-position hits through ``perm``
    (one cheap int gather) before the single packed payload gather.  The
    old eager ``build_block.take(perm)`` materialized every payload column
    twice — once at build, once at probe."""

    sorted_keys: jnp.ndarray       # int64 (n,), dead rows at +inf end
    block: Block                   # build payload, ORIGINAL row order
    perm: jnp.ndarray              # sorted position -> original row (int32)
    sorted_sel: jnp.ndarray        # selected flags in key order (bool)
    num_live: jnp.ndarray          # traced scalar
    unique: jnp.ndarray            # traced bool: no duplicate live keys

    @property
    def capacity(self) -> int:
        return int(self.sorted_keys.shape[0])

    def take_sorted(self, sidx: jnp.ndarray, fill_invalid: bool = False) -> Block:
        """Payload rows at SORTED positions ``sidx``.

        Two equivalent plans, chosen by STATIC capacities (gather cost is
        per-row): lazy composes through ``perm`` (two probe-sized
        gathers); eager materializes the key-sorted payload once (one
        build-sized + one probe-sized gather) — strictly cheaper when
        the build is no bigger than the probe, the dominant PK-FK shape.
        XLA CSEs the eager sorted payload across multiple probes."""
        if self.block.capacity <= int(sidx.shape[0]):
            sorted_block = self.block.take(self.perm)
            return sorted_block.take(sidx, fill_invalid=fill_invalid)
        comp = jnp.take(self.perm, jnp.maximum(sidx, 0))
        if fill_invalid:
            comp = jnp.where(sidx >= 0, comp, jnp.int32(-1))
        return self.block.take(comp, fill_invalid=fill_invalid)


_KEY_INF = np.int64(2**63 - 1)  # np: no backend init at import (multihost)


def build_join(
    build_block: Block, build_keys: jnp.ndarray, build_null: jnp.ndarray
) -> JoinBuild:
    selected = build_block.sel_mask()
    matchable = selected & ~build_null
    # NULL-key rows never match (key -> +inf) but stay selected so the
    # right-outer non-matched scan still emits them.  A REAL live key of
    # exactly 2^63-1 is disambiguated positionally, not by value: the
    # secondary sort key (~matchable) places real _KEY_INF rows BEFORE the
    # forced NULL/dead rows, so the matchable rows are exactly the first
    # ``num_live`` sorted positions and probe ranges clamp there.
    keys = jnp.where(matchable, build_keys, _KEY_INF)
    n = build_block.capacity
    order = jax.lax.sort(
        (keys, (~matchable).astype(jnp.int8), jnp.arange(n, dtype=jnp.int32)),
        num_keys=2,
    )
    skeys, _, perm = order
    sorted_sel = jnp.take(selected, perm)
    num_live = jnp.sum(matchable, dtype=jnp.int32)
    dup = (skeys[1:] == skeys[:-1]) & (jnp.arange(1, n) < num_live)
    unique = ~jnp.any(dup)
    return JoinBuild(skeys, build_block, perm, sorted_sel, num_live, unique)


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def _probe_ranges(build: JoinBuild, probe_keys: jnp.ndarray):
    # packed-merge probe: lo AND hi from one 1-op merged sort + one 2-op
    # route-back sort (measured 21ms vs 83ms for two sort-method
    # searchsorted calls at 1.5M keys / 2.1M probes); falls back to
    # searchsorted at runtime when the live key span exceeds 31 bits.
    # Ranges clamp into the matchable prefix: positions >= num_live hold
    # forced NULL/dead rows whose sentinel key (2^63-1) must never match
    # a probe key of that same real value.
    from .merge import probe_ranges_fast

    return probe_ranges_fast(build.sorted_keys, probe_keys, build.num_live)


def _merge_blocks(
    probe_block: Block, build_rows: Block, *, suffixes=("", "_r")
) -> Block:
    """Column concat with name disambiguation (reference join output glue)."""
    out: Dict[str, Column] = dict(zip(probe_block.names, probe_block.columns))
    for n, c in zip(build_rows.names, build_rows.columns):
        name = n if n not in out else n + suffixes[1]
        out[name] = c
    return Block.from_dict(out)


def probe_join_unique(
    build: JoinBuild,
    probe_block: Block,
    probe_keys: jnp.ndarray,
    probe_null: jnp.ndarray,
    kind: str = "inner",
) -> Tuple[Block, jnp.ndarray]:
    """1:N fast path — unique build keys (PK-FK joins; the dominant TPC-H
    shape).  Output capacity == probe capacity; each probe row matches at
    most one build row.

    Returns (joined block, matched_build_rows flag array for right-outer).
    Reference: ``Join::joinBlockHash`` (Join.cpp:1321).
    """
    probe_live = probe_block.sel_mask() & ~probe_null
    lo, hi = _probe_ranges(build, probe_keys)
    matched = probe_live & (hi > lo)
    bidx = jnp.where(matched, lo, -1)

    if kind == "semi":
        return probe_block.and_sel(matched), _matched_flags(build, bidx)
    if kind == "anti":
        # plain anti == NOT EXISTS: NULL-key rows have no match -> kept
        return probe_block.and_sel(~matched), _matched_flags(build, bidx)
    if kind == "anti_null_aware":
        sel = _null_aware_anti_sel(build, matched, probe_null)
        return probe_block.and_sel(sel), _matched_flags(build, bidx)
    if kind in ("left_outer_semi", "left_outer_semi_null_aware"):
        # EXISTS in the select list (reference LeftOuterSemiJoin): keep all
        # probe rows, append a bool 'matched' column.  Null-aware (IN in
        # select list): unmatched is NULL when the probe key is NULL or
        # the build side contains NULLs.
        from ..core.dtypes import BOOL

        if kind == "left_outer_semi":
            col = Column(matched, None, BOOL)
        else:
            selected_b = build.sorted_sel
            forced = jnp.arange(build.capacity) >= build.num_live
            build_has_null = jnp.any(selected_b & forced)
            build_empty = ~jnp.any(selected_b)
            unknown = (~matched) & (probe_null | build_has_null) & ~build_empty
            col = Column(matched, ~unknown, BOOL.with_nullable(True))
        out = probe_block.with_column("__semi_matched", col)
        return out, _matched_flags(build, bidx)

    build_rows = build.take_sorted(bidx, fill_invalid=True)
    joined = _merge_blocks(probe_block, build_rows)
    if kind == "inner":
        joined = joined.with_sel(matched)
    elif kind in ("left", "left_outer", "right_as_probe_outer"):
        joined = joined.with_sel(probe_block.sel_mask())
    else:
        raise NotImplementedError(f"join kind {kind}")
    return joined, _matched_flags(build, bidx)


def _null_aware_anti_sel(
    build: JoinBuild, matched: jnp.ndarray, probe_null: jnp.ndarray
) -> jnp.ndarray:
    """NOT IN semantics (reference: null-aware anti semi join,
    ``Interpreters/Join.cpp:1510``, design
    ``docs/design/2022-07-22-null-aware-semi-join.md``):
      - build side empty          -> keep every probe row (NOT IN {} is true)
      - probe key NULL            -> drop (NULL NOT IN (non-empty) is NULL)
      - matched                   -> drop
      - unmatched but build has a NULL key -> drop (comparison with NULL)
      - else                      -> keep
    """
    selected = build.sorted_sel
    matchable = jnp.arange(build.capacity) < build.num_live
    build_empty = ~jnp.any(selected)
    build_has_null = jnp.any(selected & ~matchable)
    keep = (~probe_null) & (~matched) & (~build_has_null)
    return jnp.where(build_empty, jnp.ones_like(keep), keep)


def cross_join(
    probe_block: Block, build_block: Block, output_capacity: int
) -> Tuple[Block, jnp.ndarray]:
    """Cartesian product (reference ``joinBlockCross``, Join.cpp:1430).

    Emits via the same prefix-sum expansion as the N:M hash probe, with
    every live probe row matching every live build row.  Returns
    (joined block, required-capacity overflow flag)."""
    build_c = build_block.compact()
    nb = build_c.num_rows()
    probe_live = probe_block.sel_mask()
    counts = jnp.where(probe_live, nb, 0).astype(jnp.int64)
    from .merge import dense_inverse

    cum = jnp.cumsum(counts)
    total = cum[-1] if counts.shape[0] else jnp.int64(0)
    start = cum - counts
    t = jnp.arange(output_capacity, dtype=jnp.int64)
    prow = dense_inverse(cum, output_capacity)
    prow_safe = jnp.minimum(prow, counts.shape[0] - 1)
    brow = (t - jnp.take(start, prow_safe)).astype(jnp.int32)
    live_out = t < total
    brow = jnp.where(live_out, jnp.minimum(brow, build_c.capacity - 1), 0)
    joined = _merge_blocks(
        probe_block.take(prow_safe), build_c.take(brow)
    ).with_sel(live_out)
    needed = jnp.where(total > output_capacity, total, 0).astype(jnp.int64)
    return joined, needed


def _matched_flags(build: JoinBuild, build_idx: jnp.ndarray) -> jnp.ndarray:
    """Which build rows were hit — feeds the non-matched scan for right/full
    outer (``ScanHashMapAfterProbeBlockInputStream`` analog).

    Sort-based membership instead of a bool scatter: sorting the hit
    positions and range-probing every build slot costs two packed sorts
    (XLA DCEs all of it for join kinds that ignore the flags)."""
    from .merge import probe_ranges_fast

    cap = build.capacity
    hits = jnp.where(build_idx >= 0, build_idx.astype(jnp.int64),
                     jnp.int64(2 ** 63 - 1))
    sorted_hits = jax.lax.sort(hits)
    num_live = jnp.sum(build_idx >= 0, dtype=jnp.int32)
    lo, hi = probe_ranges_fast(
        sorted_hits, jnp.arange(cap, dtype=jnp.int64), num_live
    )
    return hi > lo


def probe_join_general(
    build: JoinBuild,
    probe_block: Block,
    probe_keys: jnp.ndarray,
    probe_null: jnp.ndarray,
    kind: str,
    output_capacity: int,
    verify: Optional[Tuple[Sequence[str], Sequence[str]]] = None,
) -> Tuple[Block, jnp.ndarray, jnp.ndarray]:
    """N:M expansion via prefix-sum addressing.

    For output slot t: probe row = searchsorted(cum_counts, t, right), build
    row = lo[row] + (t - cum_start[row]).  Fully vectorized; overflow beyond
    ``output_capacity`` is reported, caller re-runs bigger (the analog of
    probe-side ``ProbeProcessInfo`` resumption, Join.cpp:1977).

    Returns (joined, matched_build_flags, overflow_bool)."""
    probe_live = probe_block.sel_mask() & ~probe_null
    lo, hi = _probe_ranges(build, probe_keys)
    # dead / NULL-key rows must have an empty range (their raw key bits
    # could otherwise alias a real build key)
    lo = jnp.where(probe_live, lo, 0)
    hi = jnp.where(probe_live, hi, 0)
    counts = hi - lo
    if verify is None and kind in (
        "semi", "anti", "anti_null_aware",
        "left_outer_semi", "left_outer_semi_null_aware",
    ):
        matched = probe_live & (counts > 0)
        bflags = _matched_flags(build, jnp.where(matched, lo, -1))
        if kind in ("left_outer_semi", "left_outer_semi_null_aware"):
            from ..core.dtypes import BOOL

            if kind == "left_outer_semi":
                col = Column(matched, None, BOOL)
            else:
                selected_b = build.sorted_sel
                forced = jnp.arange(build.capacity) >= build.num_live
                build_has_null = jnp.any(selected_b & forced)
                build_empty = ~jnp.any(selected_b)
                unknown = (~matched) & (probe_null | build_has_null) & ~build_empty
                col = Column(matched, ~unknown, BOOL.with_nullable(True))
            out = probe_block.with_column("__semi_matched", col)
            return out, bflags, jnp.int64(0)
        if kind == "semi":
            sel = matched
        elif kind == "anti":
            sel = ~matched
        else:
            sel = _null_aware_anti_sel(build, matched, probe_null)
        return probe_block.and_sel(sel), bflags, jnp.int64(0)
    if kind in ("left", "left_outer"):
        # every selected probe row emits at least once (NULL-key rows too)
        counts = jnp.maximum(counts, probe_block.sel_mask().astype(counts.dtype))
    from .merge import dense_inverse

    cum = jnp.cumsum(counts)
    total = cum[-1] if counts.shape[0] else jnp.int32(0)
    start = cum - counts
    t = jnp.arange(output_capacity, dtype=counts.dtype)
    prow = dense_inverse(cum, output_capacity)
    prow_safe = jnp.minimum(prow, counts.shape[0] - 1)
    k = t - jnp.take(start, prow_safe)
    has_match = jnp.take(hi, prow_safe) > jnp.take(lo, prow_safe)
    brow = jnp.take(lo, prow_safe) + k.astype(jnp.int32)
    live_out = t < total
    brow = jnp.where(live_out & has_match, brow, -1)

    verified = None
    if verify is not None:
        probe_names, build_names = verify
        pvc = [probe_block[nm].take(prow_safe) for nm in probe_names]
        bcomp = jnp.take(build.perm, jnp.maximum(brow, 0))
        bvc = [build.block[nm].take(bcomp) for nm in build_names]
        verified = _keys_equal(pvc, bvc) & has_match & live_out
        if kind in ("semi", "anti"):
            n_probe = probe_block.capacity
            hit = jnp.zeros(n_probe + 1, dtype=jnp.bool_).at[
                jnp.where(verified, prow_safe, n_probe)
            ].set(True, mode="drop")[:n_probe]
            sel = hit if kind == "semi" else ~hit
            bflags = _matched_flags(build, jnp.where(verified, brow, -1))
            needed = jnp.where(total > output_capacity, total, 0).astype(jnp.int64)
            return probe_block.and_sel(sel), bflags, needed
        if kind == "inner":
            live_out = verified
        else:
            raise NotImplementedError(
                f"hashed wide join keys not supported for kind {kind!r}"
            )

    probe_rows = probe_block.take(prow_safe)
    build_rows = build.take_sorted(brow, fill_invalid=True)
    joined = _merge_blocks(probe_rows, build_rows).with_sel(live_out)
    bflags = _matched_flags(build, jnp.where(live_out, brow, -1))
    needed = jnp.where(total > output_capacity, total, 0).astype(jnp.int64)
    return joined, bflags, needed


def scan_non_matched(build: JoinBuild, matched_flags: jnp.ndarray, probe_names: Sequence[str], probe_block: Block) -> Block:
    """Right-outer tail: build rows never hit, with NULL probe columns."""
    live = build.sorted_sel & ~matched_flags
    cols: Dict[str, Column] = {}
    n = build.capacity
    for name in probe_names:
        c = probe_block[name]
        cols[name] = Column(
            jnp.zeros(n, dtype=c.data.dtype),
            jnp.zeros(n, dtype=jnp.bool_),
            c.dtype.with_nullable(True),
            c.dictionary,
        )
    # right/full-outer only: materialize the payload in key order here
    sorted_payload = build.block.take(build.perm)
    for name, c in zip(sorted_payload.names, sorted_payload.columns):
        out_name = name if name not in cols else name + "_r"
        cols[out_name] = c
    return Block.from_dict(cols, sel=live)


# ---------------------------------------------------------------------------
# one-call convenience (single-device whole-join)
# ---------------------------------------------------------------------------


def hash_join(
    probe_block: Block,
    build_block: Block,
    probe_key_names: Sequence[str],
    build_key_names: Sequence[str],
    kind: str = "inner",
    output_capacity: Optional[int] = None,
    build_payload: Optional[Sequence[str]] = None,
):
    """Build + probe in one go.  Uses the unique fast path when the caller
    promises uniqueness via ``output_capacity is None``; otherwise general.

    ``build_payload`` narrows which build columns the probe-time payload
    gather materializes (every column the parent never reads — typically
    the duplicate join key — is pure waste); keys always stay available
    for hashed-key verification.

    Returns (joined_block, extras) where extras carries overflow/matched
    flags for the planner."""
    pk = [probe_block[k] for k in probe_key_names]
    bk = [build_block[k] for k in build_key_names]
    pkeys, pnull, bkeys, bnull = normalize_join_keys(pk, bk)
    needs_verify = join_keys_need_verify(pk, bk)
    payload_block = build_block
    if build_payload is not None:
        want = set(build_payload)
        if needs_verify:
            want |= set(build_key_names)  # re-verification reads true keys
        keep = [n for n in build_block.names if n in want]
        if not keep:  # zero-column blocks can't carry capacity: keep a key
            keep = [build_key_names[0]]
        payload_block = Block(
            names=tuple(keep),
            columns=tuple(build_block[n] for n in keep),
            sel=build_block.sel,
        )
    build = build_join(payload_block, bkeys, bnull)
    if needs_verify:
        # hashed keys: hash collisions make the unique fast path unsound
        # and candidate ranges approximate — always expand + re-verify
        if kind not in ("inner", "semi", "anti"):
            raise NotImplementedError(
                f"join keys wider than 63 bits not supported for kind {kind!r}"
            )
        joined, bflags, overflow = probe_join_general(
            build, probe_block, pkeys, pnull, kind,
            output_capacity or probe_block.capacity,
            verify=(list(probe_key_names), list(build_key_names)),
        )
    elif output_capacity is None:
        joined, bflags = probe_join_unique(build, probe_block, pkeys, pnull, kind)
        # The unique fast path silently emits only the FIRST match per probe
        # row if the caller's uniqueness promise is false (duplicate live
        # build keys).  Surface that as an overflow so the runner retries on
        # the general path instead of dropping rows (reference handles
        # duplicates unconditionally: ``Interpreters/Join.cpp:1321``).
        # Semi/anti kinds are duplicate-insensitive — no flag needed.
        if kind in ("inner", "left", "left_outer", "right_as_probe_outer"):
            overflow = jnp.where(
                build.unique, jnp.int64(0), jnp.int64(probe_block.capacity) + 1
            )
        else:
            overflow = jnp.int64(0)
    else:
        joined, bflags, overflow = probe_join_general(
            build, probe_block, pkeys, pnull, kind, output_capacity
        )
    return joined, {"build": build, "matched_flags": bflags, "overflow": overflow}


def hash_join_with_tail(
    probe_block: Block,
    build_block: Block,
    probe_key_names: Sequence[str],
    build_key_names: Sequence[str],
    kind: str,
    output_capacity: Optional[int],
    build_payload: Optional[Sequence[str]] = None,
):
    """hash_join plus the right/full-outer non-matched build tail
    (reference ``ScanHashMapAfterProbeBlockInputStream``): right outer =
    inner pass + tail, full outer = left-outer pass + tail.  Under a
    hash-shuffle each build row lives on exactly one device, so local
    matched-flags are complete and the tail needs no cross-mesh reduce."""
    probe_kind = {"right_outer": "inner", "full_outer": "left_outer"}.get(
        kind, kind
    )
    joined, extras = hash_join(
        probe_block, build_block, probe_key_names, build_key_names,
        kind=probe_kind, output_capacity=output_capacity,
        build_payload=build_payload,
    )
    if kind in ("right_outer", "full_outer"):
        from ..exchange.skew import concat_blocks

        tail = scan_non_matched(
            extras["build"], extras["matched_flags"],
            probe_block.names, probe_block,
        )
        joined = concat_blocks(joined, tail)
    return joined, extras


__all__ = [
    "JoinBuild",
    "build_join",
    "probe_join_unique",
    "probe_join_general",
    "scan_non_matched",
    "hash_join",
    "normalize_join_keys",
]
