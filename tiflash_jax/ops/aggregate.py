"""Hash aggregation without a hash table.

Role analog: ``Interpreters/Aggregator.{h,cpp}`` — the key-specialized
``AggregationMethod_*`` dispatch (``Aggregator.h:442-559``), batched execute
(``executeImplBatch``, ``Aggregator.cpp:776``) and two-level tables
(``Common/HashTable/TwoLevelHashTable.h``).

Re-design: there is no pointer-chasing hash table.  Two methods, chosen
the way the reference chooses an AggregationMethod from key types
(``Aggregator::chooseAggregationMethod``):

- ``direct``: when the combined key domain is small and statically known
  (string dictionary sizes, bools, bounded ints), keys pack into one dense
  slot id by mixed radix and aggregation is a dense segment-reduction over
  ``num_slots`` slots — the analog of ``AggregationMethod_key8/key16``
  (direct indexing, no hashing).
- ``sort``: general path — lexicographic ``lax.sort`` of the key columns
  (XLA's sort), group-boundary detection, then segmented reductions
  with sorted segment ids.  The analog of the serialized-key fallback
  (``AggregationMethod_serialized``), with the sort replacing hashing.

Both produce full-capacity padded outputs with a live-slot mask (shape
static under jit); group-count overflow beyond ``num_slots`` is reported so
the host can re-run with a bigger capacity (SURVEY.md §7 "bounded-output +
count" pattern).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.block import Block, Column
from ..core.dtypes import (
    DataType,
    Decimal,
    FLOAT64,
    INT64,
    TypeKind,
    UINT64,
)

# MySQL bit-reduction aggregates (reference AggregateFunctionBitwise.h);
# u64 accumulation, result is never NULL (empty group -> identity)
_BIT_FUNCS = ("bit_and", "bit_or", "bit_xor")
_BIT_OPS = {"bit_and": "band", "bit_or": "bor", "bit_xor": "bxor"}


def _bit_identity(func: str) -> jnp.ndarray:
    return jnp.asarray((1 << 64) - 1 if func == "bit_and" else 0, jnp.uint64)

# ---------------------------------------------------------------------------
# aggregate-function descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggDesc:
    """One aggregate: ``func(arg) AS name [FILTER cond_col]``.

    func ∈ {sum, count, avg, min, max, count_distinct}.  ``arg`` is None
    for count(*).  ``filter_col`` names a boolean column and implements
    the ``-If`` combinator (rows where it is false/NULL don't contribute).
    Reference: ``AggregateFunctions/registerAggregateFunctions.cpp:51``
    and the combinator registry (``-If``, ``-Null``, ``-Merge``,
    ``-State`` — merge/state are the partial/final split here).
    """

    func: str
    arg: Optional[str]
    name: str
    filter_col: Optional[str] = None
    # function parameter (quantile fraction for 'quantile'; max collected
    # items for 'group_concat' — the group_concat_max_len analog)
    param: Optional[float] = None
    # group_concat separator
    separator: str = ","
    # group_concat DISTINCT: deduplicated values, emitted in value order
    # (binary-collation ascending — MySQL's DISTINCT-tree order)
    distinct: bool = False


def agg_result_dtype(func: str, arg: Optional[DataType]) -> DataType:
    """TiDB result-type rules (``AggregateFunctions/AggregateFunctionSum.h:293``
    via ``SumDecimalInferer``/``AvgDecimalInferer``, ``Common/Decimal.h:156``:
    sum widens precision by decimal_longlong_digits=22, avg adds
    DIV_PRECISION_INCREMENT=4 to precision and scale; both cap at 65,
    the reference's Decimal256 maximum — four limbs here)."""
    if func in ("count", "count_distinct", "approx_count_distinct",
                "approx_cd_partial", "approx_cd_final"):
        return INT64
    assert arg is not None
    if func in ("min", "max", "first"):
        return arg.with_nullable(True)
    if func == "sum":
        if arg.is_decimal:
            return Decimal(min(arg.precision + 22, 65), arg.scale, nullable=True)
        if arg.is_float:
            return FLOAT64.with_nullable(True)
        if arg.is_unsigned:
            # BIGINT UNSIGNED keeps its 2^64 magnitude (accumulation is
            # the same int64 bit pattern; only the TYPE must say so).
            # MySQL types this DECIMAL; overflow past 2^64 is outside
            # the engine's envelope (reference: round.test uint64 sums)
            return UINT64.with_nullable(True)
        return INT64.with_nullable(True)
    if func == "avg":
        if arg.is_float:
            return FLOAT64.with_nullable(True)
        if arg.is_decimal:
            return Decimal(min(arg.precision + 4, 65), min(arg.scale + 4, 30),
                           nullable=True)
        return Decimal(18, 4, nullable=True)
    if func in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
        return FLOAT64.with_nullable(True)
    if func == "quantile":
        return arg.with_nullable(True)
    if func == "group_concat":
        return arg.with_nullable(True)
    if func in _BIT_FUNCS:
        return UINT64  # MySQL: BIGINT UNSIGNED, never NULL
    raise NotImplementedError(f"aggregate {func}")


# ---------------------------------------------------------------------------
# wide-decimal (precision 19..38) sum/avg
# ---------------------------------------------------------------------------

# scaled-sum magnitudes below this are provably exact in int64 accumulation
_WIDE_SAFE = 2 ** 62


def _abs_bound(col: Column) -> Optional[int]:
    if col.stats is None:
        return None
    return max(abs(int(col.stats[0])), abs(int(col.stats[1])))


def _wide_rewrite(block: Block, aggs: Sequence[AggDesc],
                  rows: Optional[int] = None):
    """Exact wide-decimal (result precision > 18) sum/avg AROUND the
    unchanged int64 aggregation methods.

    Two physical strategies, chosen per aggregate from column range
    statistics (the MinMaxIndex analog on ``Column.stats``):

    - **narrow-stored**: when stats prove ``rows * max|mantissa| * 10^shift``
      fits int64, the method's int64 accumulation is already exact and its
      1-D output is simply *typed* wide (the result-side mirror of the
      reference's Decimal32/64 physical narrowing,
      ``DataTypes/DataTypeDecimal.h``).  Zero extra compute — this is the
      path every TPC-H sum takes when scanned columns carry stats.
    - **digit decomposition**: otherwise the argument splits into base-10^9
      digit columns (2 for int64 mantissas, 4 for two-limb ``(n, 2)``
      inputs e.g. partial-aggregate states), each digit is summed by the
      unchanged method (digit sums cannot overflow below ~9e9 rows), and
      the digit sums carry-normalize into a two-limb column
      (``core/wide.py``) — bit-exact regardless of value distribution.

    ``rows`` (default: the block's capacity) is the row count the
    int64-exactness proof covers; a caller that accumulates a block tile
    by tile passes the whole input's.

    Returns None when no aggregate needs widening, else
    ``(block', aggs', post)`` where ``post`` maps the method's result block
    back to the requested schema.  Reference: Decimal128/256 sum states,
    ``AggregateFunctions/AggregateFunctionSum.h:331``.
    """
    from ..core.wide import (
        digits_of_i64,
        digits_of_wide,
        renorm_digits,
        wide_div_round_half_up,
        wide_mul_pow10,
    )

    def _is_wide2(c: Column) -> bool:
        return c.dtype.is_wide_decimal and c.data.ndim == 2

    relevant = [
        a for a in aggs
        if a.func in ("sum", "avg") and a.arg is not None
        and block[a.arg].dtype.is_decimal
        and agg_result_dtype(a.func, block[a.arg].dtype).is_wide_decimal
    ]
    minmax = [
        a for a in aggs
        if a.func in ("min", "max", "first") and a.arg is not None
        and _is_wide2(block[a.arg])
    ]
    for a in aggs:
        if (
            a.arg is not None
            and _is_wide2(block[a.arg])
            and a.func not in ("sum", "avg", "count", "min", "max", "first")
        ):
            raise NotImplementedError(
                f"{a.func} over a two-limb wide-decimal column"
            )
    if not relevant and not minmax:
        return None

    rows = block.capacity if rows is None else rows
    out_block = block
    aggs2: List[AggDesc] = []
    skip: set = set()
    assemble: dict = {}
    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        if a in minmax:
            # min/max/first over a two-limb column: aggregate an
            # order-preserving int64 RANK surrogate (one lexicographic
            # (hi, lo) sort), then gather the real value back by rank in
            # post — the positional trick that keeps the methods int64
            n = col.data.shape[0]
            L = col.data.shape[-1]
            iota = jnp.arange(n, dtype=jnp.int64)
            limbs = tuple(col.data[:, j] for j in range(L))
            sorted_ops = jax.lax.sort(
                limbs + (iota,), num_keys=L, is_stable=True,
            )
            s_row = sorted_ops[-1]
            # inverse permutation via a 2-operand sort instead of a
            # random scatter (ops/segments.py)
            from .segments import route_by_positions

            ranks = route_by_positions(s_row, iota)
            nm = f"__wm__{a.name}"
            out_block = out_block.with_column(nm, Column(ranks, col.validity, INT64))
            res_nm = f"__wmr__{a.name}"
            aggs2.append(AggDesc(a.func, nm, res_nm, a.filter_col))
            assemble[res_nm] = (
                "rank_gather", a, jnp.stack(sorted_ops[:-1], axis=-1),
                agg_result_dtype(a.func, col.dtype),
            )
            continue
        if a not in relevant:
            aggs2.append(a)
            continue
        rdt = agg_result_dtype(a.func, col.dtype)
        shift = rdt.scale - col.dtype.scale
        wide_in = col.data.ndim == 2
        if not wide_in:
            b = _abs_bound(col)
            if b is not None and b * rows * (10 ** shift) < _WIDE_SAFE:
                aggs2.append(a)
                vb = b * rows if a.func == "sum" else b * (10 ** shift)
                assemble[a.name] = ("narrow", vb)
                continue
        digs = (
            digits_of_wide(col.data)
            if wide_in
            else digits_of_i64(col.data.astype(jnp.int64))
        )
        sum_names = []
        for j, d in enumerate(digs):
            nm = f"__wd{j}__{a.name}"
            out_block = out_block.with_column(nm, Column(d, col.validity, INT64))
            sum_names.append(f"__ws{j}__{a.name}")
            aggs2.append(AggDesc("sum", nm, sum_names[-1], a.filter_col))
        cnt_name = None
        if a.func == "avg":
            cnt_name = f"__wc__{a.name}"
            aggs2.append(
                AggDesc("count", f"__wd0__{a.name}", cnt_name, a.filter_col)
            )
            skip.add(cnt_name)
        skip.update(sum_names[1:])
        assemble[sum_names[0]] = ("wide", a, sum_names, cnt_name, shift, rdt)

    def post(res: Block) -> Block:
        names: List[str] = []
        cols: List[Column] = []
        d = res.as_dict()
        for nm in res.names:
            if nm in skip:
                continue
            spec = assemble.get(nm)
            if spec is None:
                names.append(nm)
                cols.append(d[nm])
                continue
            if spec[0] == "narrow":
                c = d[nm]
                names.append(nm)
                cols.append(Column(c.data, c.validity, c.dtype,
                                   stats=(-spec[1], spec[1])))
                continue
            if spec[0] == "rank_gather":
                _, a, sorted_w, rdt = spec
                c = d[nm]
                idx = jnp.clip(c.data, 0, sorted_w.shape[0] - 1).astype(jnp.int32)
                names.append(a.name)
                cols.append(Column(jnp.take(sorted_w, idx, axis=0),
                                   c.validity, rdt))
                continue
            _, a, sum_names, cnt_name, shift, rdt = spec
            validity = d[sum_names[0]].validity
            # result limbs follow the TYPED precision (2 for p<=38, 4 for
    # the Decimal256 analog); renorm saturates past the physical
            # ceiling (flag currently dropped — the reference errors there)
            w, _ovf = renorm_digits([d[s].data for s in sum_names],
                                    limbs=rdt.decimal_limbs)
            if a.func == "avg":
                if shift:
                    w, _ = wide_mul_pow10(w, shift)
                w = wide_div_round_half_up(
                    w, jnp.maximum(d[cnt_name].data, 1)
                )
            names.append(a.name)
            cols.append(Column(w, validity, rdt))
        return Block(names=tuple(names), columns=tuple(cols), sel=res.sel,
                     clustered_by=res.clustered_by)

    return out_block, aggs2, post


# ---------------------------------------------------------------------------
# key packing (direct method eligibility)
# ---------------------------------------------------------------------------


def key_domain_size(col: Column) -> Optional[int]:
    """Statically known key domain, if any: |dictionary| for strings, 2 for
    bool.  (+1 slot for NULL when nullable.)"""
    base: Optional[int] = None
    if col.dtype.is_string and col.dictionary is not None:
        base = max(1, len(col.dictionary))
    elif col.dtype.kind is TypeKind.BOOL:
        base = 2
    if base is None:
        return None
    return base + (1 if col.dtype.nullable or col.validity is not None else 0)


def pack_keys_direct(cols: Sequence[Column]) -> Optional[Tuple[jnp.ndarray, int]]:
    """Mixed-radix pack of small-domain keys -> (slot_ids int32, domain)."""
    domains = [key_domain_size(c) for c in cols]
    if any(d is None for d in domains):
        return None
    total = 1
    for d in domains:
        total *= d
    slot = None
    for c, d in zip(cols, domains):
        v = c.data.astype(jnp.int32)
        if c.validity is not None:
            v = jnp.where(c.validity, v + 1, 0)  # NULL -> slot 0 of this radix
        elif c.dtype.nullable:
            v = v + 1
        slot = v if slot is None else slot * jnp.int32(d) + v
    return slot, total


def unpack_keys_direct(
    slots: jnp.ndarray, cols: Sequence[Column]
) -> List[Column]:
    """Inverse of pack_keys_direct for materializing group-key columns."""
    domains = [key_domain_size(c) for c in cols]
    out: List[Column] = []
    rem = slots
    for c, d in reversed(list(zip(cols, domains))):
        v = rem % d
        rem = rem // d
        if c.validity is not None or c.dtype.nullable:
            validity = v > 0
            data = jnp.maximum(v - 1, 0)
        else:
            validity = None
            data = v
        out.append(
            Column(data.astype(c.dtype.jnp_dtype), validity, c.dtype, c.dictionary)
        )
    out.reverse()
    return out


DIRECT_DOMAIN_LIMIT = 4096


# ---------------------------------------------------------------------------
# segmented reduction helpers
# ---------------------------------------------------------------------------

def _identity_for(func: str, dtype: DataType):
    phys = dtype.jnp_dtype
    if func == "min":
        if dtype.is_float:
            return jnp.asarray(jnp.inf, phys)
        return jnp.asarray(jnp.iinfo(phys).max, phys)
    if func == "max":
        if dtype.is_float:
            return jnp.asarray(-jnp.inf, phys)
        return jnp.asarray(jnp.iinfo(phys).min, phys)
    return jnp.asarray(0, phys)


def _segment_reduce(func: str, data, gids, num_slots: int, *, sorted_ids: bool):
    kw = dict(num_segments=num_slots, indices_are_sorted=sorted_ids)
    if func == "sum":
        return jax.ops.segment_sum(data, gids, **kw)
    if func == "min":
        return jax.ops.segment_min(data, gids, **kw)
    if func == "max":
        return jax.ops.segment_max(data, gids, **kw)
    raise NotImplementedError(func)


def _distinct_first_flags(
    block: Block, keys: Sequence[str], arg: str, live: jnp.ndarray
) -> jnp.ndarray:
    """Bool row mask: True on the first live occurrence of each
    (group-keys, arg) pair — sort by (keys, arg), boundary-detect, scatter
    back to input order.  Powers exact count_distinct (the reference uses
    HLL-family ``uniq`` states; exactness is affordable here because the
    sort is one fused program)."""
    n = block.capacity
    operands: List[jnp.ndarray] = [~live]
    for name in list(keys) + [arg]:
        c = block[name]
        if c.validity is not None:
            operands.append(~c.validity)
            # NULL slots carry arbitrary data (join payloads): canonicalize
            # so all NULLs compare equal at boundary detection
            operands.append(jnp.where(c.validity, c.data,
                                      jnp.zeros_like(c.data)))
        else:
            operands.append(c.data)
    nk = len(operands)
    operands.append(jnp.arange(n, dtype=jnp.int32))
    sorted_ops = jax.lax.sort(tuple(operands), num_keys=nk)
    perm = sorted_ops[-1]
    neq = jnp.zeros(n, dtype=jnp.bool_)
    for arr in sorted_ops[:-1]:
        neq = neq | (arr != jnp.roll(arr, 1))
    neq = neq.at[0].set(True)
    from .segments import route_by_positions

    return route_by_positions(perm, neq)


def _compute_distinct_flags(
    block: Block, keys: Sequence[str], aggs: Sequence[AggDesc], live: jnp.ndarray
) -> dict:
    out = {}
    for a in aggs:
        if a.func not in ("count_distinct", "quantile"):
            continue
        base = live
        if a.filter_col is not None:
            f = block[a.filter_col]
            m = f.data.astype(jnp.bool_)
            if f.validity is not None:
                m = m & f.validity
            base = live & m
        if a.func == "count_distinct":
            out[a.name] = _distinct_first_flags(block, keys, a.arg, base)
        else:
            out[a.name] = _quantile_row_flags(
                block, keys, a.arg, a.param if a.param is not None else 0.5, base
            )
    return out


def _quantile_row_flags(
    block: Block, keys: Sequence[str], arg: str, q: float, live: jnp.ndarray
) -> jnp.ndarray:
    """Bool mask marking, per group, the row holding the q-quantile of
    ``arg`` (element at floor(q*(n_valid-1)) in per-group sorted order;
    the exact-selection analog of the reference's quantile states).
    Computed in input row order like the distinct flags."""
    n = block.capacity
    c = block[arg]
    valid = live if c.validity is None else (live & c.validity)
    operands: List[jnp.ndarray] = [~live]
    for name in keys:
        kc = block[name]
        if kc.validity is not None:
            operands.append(~kc.validity)
        operands.append(kc.data)
    n_group_ops = len(operands)
    operands.append(~valid)  # valid arg values first within the group
    operands.append(c.data)
    nk = len(operands)
    operands.append(jnp.arange(n, dtype=jnp.int32))
    sorted_ops = jax.lax.sort(tuple(operands), num_keys=nk)
    perm = sorted_ops[-1]
    gb = jnp.zeros(n, dtype=jnp.bool_)
    for arr in sorted_ops[:n_group_ops]:
        gb = gb | (arr != jnp.roll(arr, 1))
    gb = gb.at[0].set(True)
    pos = jnp.arange(n, dtype=jnp.int64)
    gid = jnp.cumsum(gb.astype(jnp.int32)) - 1
    from .segments import forward_fill_positions

    start = forward_fill_positions(gb).astype(jnp.int64)
    valid_s = jnp.take(valid, perm)
    cnt = jax.ops.segment_sum(valid_s.astype(jnp.int64), gid, num_segments=n)
    cnt_row = jnp.take(cnt, gid)
    target = start + jnp.floor(q * (cnt_row - 1).astype(jnp.float64)).astype(jnp.int64)
    flag_sorted = (pos == target) & valid_s
    from .segments import route_by_positions

    return route_by_positions(perm, flag_sorted)


# ---------------------------------------------------------------------------
# the two aggregation methods
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggregateResult:
    block: Block            # group keys + agg outputs; sel marks live slots
    num_groups: jnp.ndarray  # traced scalar
    # traced int: 0 = fits; else the slot capacity actually required
    # (drives one-shot capacity retries instead of blind doubling)
    overflow: jnp.ndarray


def _accumulate(
    aggs: Sequence[AggDesc],
    block: Block,
    gids: jnp.ndarray,
    live: jnp.ndarray,
    num_slots: int,
    sorted_ids: bool,
    distinct_flags: Optional[dict] = None,
    sorted_layout: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    spans_all_live: bool = True,
) -> List[Tuple[str, Column]]:
    """Shared accumulation: compute every aggregate into dense slot arrays.

    ``gids`` must already be clipped to [0, num_slots]; dead rows carry
    gid == num_slots (dropped via an extra trash slot).
    ``distinct_flags``: per count_distinct agg name, a bool row mask that
    is True on the first occurrence of each (group, value) pair (in the
    same row order as ``block``).
    ``sorted_layout``: (group_start_flags, ends_dense) for sorted rows —
    enables scatter-free segmented reduction: per-group results come from
    cumulative scans differenced/read at each group's last row, with
    no scatter-add.
    """
    out: List[Tuple[str, Column]] = []
    S = num_slots + 1  # trailing trash slot for dead rows

    if sorted_layout is not None:
        first_flags, ends_dense = sorted_layout
        ends_ok = ends_dense >= 0
        e_idx = jnp.maximum(ends_dense, 0)
        prev_e = jnp.concatenate(
            [jnp.full((1,), -1, ends_dense.dtype), ends_dense[:-1]]
        )
        # group sizes come free from the dense ends (groups are dense in
        # slot order, so slot g's start is slot g-1's end + 1)
        group_sizes = jnp.where(
            ends_ok, (ends_dense - prev_e).astype(jnp.int64), 0
        )

    def segreduce(op: str, vals: jnp.ndarray) -> jnp.ndarray:
        if sorted_layout is None:
            return _segment_reduce(op, vals, gids, S, sorted_ids=sorted_ids)[:num_slots]
        if op == "sum" and not jnp.issubdtype(vals.dtype, jnp.floating):
            # exact integer path: global cumsum differenced at group ends;
            # the previous group's cumsum-at-end is this result shifted,
            # so only ONE gather is needed
            ps = jnp.cumsum(vals)
            at_end = jnp.take(ps, e_idx)
            at_prev = jnp.concatenate([jnp.zeros(1, dtype=at_end.dtype), at_end[:-1]])
            return jnp.where(ends_ok, at_end - at_prev, 0).astype(vals.dtype)
        # float sums and min/max: boundary-resetting segmented scan keeps
        # magnitudes per-group (global-cumsum differencing cancels
        # catastrophically for floats), read at each group's last row
        from .window import _segmented_prefix

        run = _segmented_prefix(op, vals, first_flags)
        return jnp.take(run, e_idx)  # padding slots masked by cnt>0 upstream

    def agg_live(a: AggDesc) -> jnp.ndarray:
        """Row mask for one aggregate: live rows passing its -If filter."""
        if a.filter_col is None:
            return live
        f = block[a.filter_col]
        m = f.data.astype(jnp.bool_)
        if f.validity is not None:
            m = m & f.validity
        return live & m

    # per-slot non-null counts are needed by count/avg and null-ness of sums
    def nn_count(col: Optional[Column], base: jnp.ndarray) -> jnp.ndarray:
        if (
            sorted_layout is not None
            and spans_all_live
            and base is live
            and (col is None or col.validity is None)
        ):
            # live rows of a group are exactly its span: size is free
            return group_sizes
        ones = base.astype(jnp.int64)
        if col is not None and col.validity is not None:
            ones = ones * col.validity.astype(jnp.int64)
        return segreduce("sum", ones)

    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        rdt = agg_result_dtype(a.func, col.dtype if col else None)
        base = agg_live(a)
        if a.func == "count":
            cnt = nn_count(col, base)
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        if a.func == "count_distinct":
            flags = distinct_flags[a.name]
            cnt = nn_count(col, base & flags)
            out.append((a.name, Column(cnt, None, INT64)))
            continue
        if a.func == "group_concat":
            # Per-group code list as a (num_slots, max_items) GATHER matrix
            # (never a scatter): valid values sit contiguously at each
            # group's span start (the sort put NULL args at the tail), so
            # slot g item j lives at row start_g + j.  Host side joins
            # dictionary strings with the separator at decode time —
            # fixed-width on device, varlen only at output
            # (reference: AggregateFunctionGroupConcat, TiDB
            # group_concat_max_len truncation ≈ max_items cap).
            if sorted_layout is None:
                raise NotImplementedError("group_concat requires the sort method")
            if col is None or col.dictionary is None:
                raise NotImplementedError(
                    "group_concat argument must be a dictionary string column"
                )
            max_items = int(a.param) if a.param else 64
            n_rows = col.data.shape[0]
            item = jnp.arange(max_items, dtype=jnp.int32)
            if a.distinct:
                # contributing rows sit value-sorted at each group's span
                # start (the sort added the arg as an in-group key), so a
                # distinct value's FIRST row marks it; compact those row
                # positions into a dense table and gather per (slot, item).
                from .merge import flagged_positions

                vrow = base if col.validity is None else (base & col.validity)
                newval = col.data != jnp.roll(col.data, 1)
                dist_first = vrow & (first_flags | newval)
                dcnt = segreduce("sum", dist_first.astype(jnp.int64))
                compact = flagged_positions(dist_first, n_rows)
                dstarts = jnp.concatenate(
                    [jnp.zeros(1, jnp.int64), jnp.cumsum(dcnt)[:-1]]
                ).astype(jnp.int32)
                idx = jnp.clip(dstarts[:, None] + item[None, :], 0, n_rows - 1)
                cpos = jnp.take(compact, idx.reshape(-1)).reshape(idx.shape)
                codes = jnp.take(
                    col.data, jnp.maximum(cpos, 0).reshape(-1)
                ).reshape(idx.shape)
                shown = dcnt
            else:
                # contributing rows (live, passing -If, non-NULL arg) are
                # contiguous at the span start in input-row order
                codes_src = col.data
                valid_cnt = nn_count(col, base)
                starts = jnp.maximum(prev_e + 1, 0).astype(jnp.int32)
                idx = jnp.clip(starts[:, None] + item[None, :], 0, n_rows - 1)
                codes = jnp.take(codes_src, idx.reshape(-1)).reshape(idx.shape)
                shown = valid_cnt
            vmat = item[None, :] < jnp.minimum(shown, max_items)[:, None].astype(
                jnp.int32
            )
            out.append((a.name, Column(codes, vmat, rdt, col.dictionary,
                                       concat_sep=a.separator)))
            continue
        if a.func == "quantile":
            flags = distinct_flags[a.name]
            ident = _identity_for("max", col.dtype)
            vals = jnp.where(base & flags, col.data, ident)
            red = segreduce("max", vals)
            cnt = nn_count(col, base)
            out.append((a.name, Column(red.astype(rdt.jnp_dtype), cnt > 0, rdt, col.dictionary)))
            continue
        if a.func in ("var_pop", "var_samp", "stddev_pop", "stddev_samp"):
            # sum / sum-of-squares decomposition (f64): the reference's
            # AggregateFunctionsStatisticsSimple moment states
            valid_row = base if col.validity is None else (base & col.validity)
            x = col.data.astype(jnp.float64)
            if col.dtype.is_decimal:
                x = x / (10 ** col.dtype.scale)
            x = jnp.where(valid_row, x, 0.0)
            s1 = segreduce("sum", x)
            s2 = segreduce("sum", x * x)
            cnt = nn_count(col, base)
            nf = jnp.maximum(cnt, 1).astype(jnp.float64)
            var = jnp.maximum(s2 / nf - (s1 / nf) ** 2, 0.0)
            if a.func.endswith("samp"):
                var = var * nf / jnp.maximum(nf - 1.0, 1.0)
                ok = cnt > 1
            else:
                ok = cnt > 0
            data = jnp.sqrt(var) if a.func.startswith("stddev") else var
            out.append((a.name, Column(data, ok, rdt)))
            continue
        assert col is not None
        valid_row = base if col.validity is None else (base & col.validity)
        if a.func in ("sum", "avg"):
            acc_dt = FLOAT64 if col.dtype.is_float else INT64
            vals = col.data.astype(acc_dt.jnp_dtype)
            vals = jnp.where(valid_row, vals, _identity_for("sum", acc_dt))
            sums = segreduce("sum", vals)
            cnt = nn_count(col, base)
            if a.func == "sum":
                scale_shift = rdt.scale - (col.dtype.scale if col.dtype.is_decimal else 0)
                if rdt.is_decimal and scale_shift:
                    sums = sums * (10 ** scale_shift)
                out.append((a.name, Column(sums.astype(rdt.jnp_dtype), cnt > 0, rdt)))
            else:  # avg = sum / count with TiDB scale rules
                from ..expr.functions import _div_round_half_up  # local: avoid cycle

                if rdt.is_decimal:
                    src_scale = col.dtype.scale if col.dtype.is_decimal else 0
                    num = sums * (10 ** (rdt.scale - src_scale))
                    data = _div_round_half_up(num, jnp.maximum(cnt, 1))
                else:
                    data = sums / jnp.maximum(cnt, 1).astype(jnp.float64)
                out.append((a.name, Column(data.astype(rdt.jnp_dtype), cnt > 0, rdt)))
        elif a.func in ("min", "max"):
            ident = _identity_for(a.func, col.dtype)
            vals = jnp.where(valid_row, col.data, ident)
            red = segreduce(a.func, vals)
            cnt = nn_count(col, base)
            out.append(
                (a.name, Column(red.astype(rdt.jnp_dtype), cnt > 0, rdt, col.dictionary))
            )
        elif a.func == "first":
            # any_value/first_row: value at the group's first valid row
            n_rows = col.data.shape[0]
            pos = jnp.arange(n_rows, dtype=jnp.int64)
            pmin = segreduce("min", jnp.where(valid_row, pos, n_rows))
            cnt = nn_count(col, base)
            idx = jnp.minimum(pmin, n_rows - 1).astype(jnp.int32)
            out.append((a.name, Column(
                jnp.take(col.data, idx), cnt > 0, rdt, col.dictionary)))
        elif a.func in _BIT_FUNCS:
            # u64 bit reduction; NULL rows contribute the identity, so the
            # result is never NULL (MySQL AggregateFunctionBitwise.h)
            ident = _bit_identity(a.func)
            vals = jnp.where(valid_row, col.data.astype(jnp.uint64), ident)
            red = segreduce(_BIT_OPS[a.func], vals)
            out.append((a.name, Column(red, None, rdt)))
        else:
            raise NotImplementedError(a.func)
    return out


MASKED_DOMAIN_LIMIT = 64

def _accumulate_masked(
    aggs: Sequence[AggDesc],
    block: Block,
    slot_ids: jnp.ndarray,
    live: jnp.ndarray,
    domain: int,
) -> Tuple[List[Tuple[str, Column]], jnp.ndarray]:
    """Tiny-domain accumulation as S fused masked reductions.

    XLA multi-output-fuses the S x (aggregates) reductions over the same
    input into a few passes: no scatter, native int64 adds."""
    slot_masks = [(slot_ids == jnp.int32(s)) & live for s in range(domain)]

    def agg_live(a: AggDesc) -> jnp.ndarray:
        if a.filter_col is None:
            return live
        f = block[a.filter_col]
        m = f.data.astype(jnp.bool_)
        if f.validity is not None:
            m = m & f.validity
        return live & m

    out: List[Tuple[str, Column]] = []
    occupied = jnp.stack([jnp.any(m) for m in slot_masks])

    def per_slot(fn):
        return jnp.stack([fn(s) for s in range(domain)])

    # sum/avg (and count) over the same (arg, filter) share one reduction
    # set — Q1-style plans pair sum(x) with avg(x) for several columns, and
    # this halves the per-slot reductions without relying on XLA CSE
    memo_sums: dict = {}
    memo_cnts: dict = {}

    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        rdt = agg_result_dtype(a.func, col.dtype if col else None)
        base = agg_live(a)
        extra = None if a.filter_col is None else (base)
        valid = base if (col is None or col.validity is None) else (base & col.validity)

        def nn(s):
            m = slot_masks[s] if extra is None else (slot_masks[s] & extra)
            mm = m if (col is None or col.validity is None) else (m & col.validity)
            return jnp.sum(mm, dtype=jnp.int64)

        def counts():
            key = (a.arg, a.filter_col)
            if key not in memo_cnts:
                memo_cnts[key] = per_slot(nn)
            return memo_cnts[key]

        if a.func == "count":
            out.append((a.name, Column(counts(), None, INT64)))
            continue
        assert col is not None
        acc_dt = FLOAT64 if col.dtype.is_float else INT64
        data = col.data.astype(acc_dt.jnp_dtype)
        if a.func in ("sum", "avg"):
            cnts = counts()
            skey = (a.arg, a.filter_col)
            if skey not in memo_sums:
                memo_sums[skey] = per_slot(
                    lambda s: jnp.sum(jnp.where(slot_masks[s] & valid, data, 0))
                )
            out.append((a.name, additive_result(a, col, memo_sums[skey], cnts)))
        elif a.func in ("min", "max"):
            ident = _identity_for(a.func, col.dtype)
            red_fn = jnp.min if a.func == "min" else jnp.max
            reds = per_slot(
                lambda s: red_fn(jnp.where(slot_masks[s] & valid, col.data, ident))
            )
            cnts = per_slot(nn)
            out.append(
                (a.name, Column(reds.astype(rdt.jnp_dtype), cnts > 0, rdt, col.dictionary))
            )
        elif a.func == "first":
            n_rows = col.data.shape[0]
            pos = jnp.arange(n_rows, dtype=jnp.int64)
            pmins = per_slot(
                lambda s: jnp.min(jnp.where(slot_masks[s] & valid, pos, n_rows))
            )
            cnts = per_slot(nn)
            idx = jnp.minimum(pmins, n_rows - 1).astype(jnp.int32)
            out.append((a.name, Column(
                jnp.take(col.data, idx), cnts > 0, rdt, col.dictionary)))
        elif a.func in _BIT_FUNCS:
            ident = _bit_identity(a.func)
            bfn = {"bit_and": jax.lax.bitwise_and, "bit_or": jax.lax.bitwise_or,
                   "bit_xor": jax.lax.bitwise_xor}[a.func]
            u = col.data.astype(jnp.uint64)
            reds = per_slot(
                lambda s: jax.lax.reduce(
                    jnp.where(slot_masks[s] & valid, u, ident), ident, bfn, (0,))
            )
            out.append((a.name, Column(reds, None, rdt)))
        else:
            raise NotImplementedError(f"masked method: {a.func}")
    return out, occupied


def additive_result(a: AggDesc, col: Column, sums: jnp.ndarray,
                    cnts: jnp.ndarray) -> Column:
    """The sum or avg result column of ``a`` over ``col`` from per-group
    sums and non-NULL counts (NULL where a group counted no value)."""
    rdt = agg_result_dtype(a.func, col.dtype)
    if a.func == "sum":
        return Column(sums.astype(rdt.jnp_dtype), cnts > 0, rdt)
    from ..expr.functions import _div_round_half_up

    if rdt.is_decimal:
        src = col.dtype.scale if col.dtype.is_decimal else 0
        num = sums * (10 ** (rdt.scale - src))
        d = _div_round_half_up(num, jnp.maximum(cnts, 1))
    else:
        d = sums / jnp.maximum(cnts, 1).astype(jnp.float64)
    return Column(d.astype(rdt.jnp_dtype), cnts > 0, rdt)


def _masked_eligible(block: Block, aggs: Sequence[AggDesc]) -> bool:
    return all(
        a.func in ("sum", "count", "avg", "min", "max", "first") + _BIT_FUNCS
        for a in aggs
    )


def aggregate_direct(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    slots_domain: Tuple[jnp.ndarray, int],
) -> AggregateResult:
    """Dense small-domain aggregation (direct-indexed method).

    Sub-method choice: tiny domains (<= MASKED_DOMAIN_LIMIT) use fused
    masked reductions (memory-bound, see _accumulate_masked); larger
    domains the XLA segment path (an unsorted scatter-add)."""
    slot_ids, domain = slots_domain
    live = block.sel_mask()
    if domain <= MASKED_DOMAIN_LIMIT and _masked_eligible(block, aggs):
        acc, occupied = _accumulate_masked(aggs, block, slot_ids, live, domain)
    else:
        gids = jnp.where(live, slot_ids, jnp.int32(domain))
        dflags = _compute_distinct_flags(block, keys, aggs, live)
        acc = _accumulate(aggs, block, gids, live, domain, sorted_ids=False,
                          distinct_flags=dflags)
        occupied = _segment_reduce(
            "sum", live.astype(jnp.int32), gids, domain + 1, sorted_ids=False
        )[:domain] > 0
    key_cols = unpack_keys_direct(jnp.arange(domain, dtype=jnp.int32),
                                  [block[k] for k in keys])
    names = tuple(keys) + tuple(n for n, _ in acc)
    cols = tuple(key_cols) + tuple(c for _, c in acc)
    out = Block(names=names, columns=cols, sel=occupied)
    return AggregateResult(out, jnp.sum(occupied, dtype=jnp.int32), jnp.int64(0))


def aggregate_sort(
    block: Block, keys: Sequence[str], aggs: Sequence[AggDesc], num_slots: int
) -> AggregateResult:
    """General sort-based aggregation.

    Dead rows sort last (extra leading live-flag key), group ids come from
    boundary detection on the sorted keys, reductions use sorted segment
    ids.

    When exactly one count_distinct/quantile aggregate is present, its
    argument rides as a trailing sort key: group boundaries are unchanged
    and the distinct/quantile flags come straight off the sorted operands
    — no O(n) scatter-back of flags."""
    n = block.capacity
    live = block.sel_mask()
    key_cols = [block[k] for k in keys]

    gcs = [a for a in aggs if a.func == "group_concat"]

    def _gc_invalid(a: AggDesc) -> Optional[jnp.ndarray]:
        """Rows NOT contributing to this group_concat (failing the -If
        filter or NULL arg) — they must sort to the group tail so the
        contributing rows form a contiguous span at the group start."""
        inv = None
        if a.filter_col is not None:
            f = block[a.filter_col]
            m = f.data.astype(jnp.bool_)
            if f.validity is not None:
                m = m & f.validity
            inv = ~m
        gcol = block[a.arg]
        if gcol.validity is not None:
            inv = ~gcol.validity if inv is None else (inv | ~gcol.validity)
        return inv

    gc_orders = [(a, _gc_invalid(a)) for a in gcs]
    if sum(1 for a, inv in gc_orders if inv is not None or a.distinct) > 1:
        raise NotImplementedError(
            "at most one group_concat with a nullable/filtered/DISTINCT "
            "argument per aggregation (each needs its own in-group order)"
        )
    special = [a for a in aggs if a.func in ("count_distinct", "quantile")]
    in_sort_special = (
        len(special) == 1 and special[0].filter_col is None and not gcs
    )

    operands: List[jnp.ndarray] = [~live]  # False (live) sorts first
    for c in key_cols:
        # a wide-decimal key contributes one operand PER LIMB (limbs are
        # non-negative, so limb-lexicographic == value order; issue_8111)
        datas = ([c.data[:, i] for i in range(c.data.shape[1])]
                 if c.data.ndim == 2 else [c.data])
        validity = c.validity
        if validity is not None and validity.ndim == 2:
            validity = validity.all(axis=1)
        if validity is not None:
            operands.append(~validity)  # NULLs group together, sort first
            # canonicalize NULL slots: producers like left-outer joins
            # leave arbitrary payload data under validity=False, which
            # would split the NULL group at boundary detection
            operands.extend(jnp.where(validity, d, jnp.zeros_like(d))
                            for d in datas)
        else:
            operands.extend(datas)
    num_group_keys = len(operands)
    if in_sort_special:
        sc = block[special[0].arg]
        operands.append(~sc.valid_mask())  # valid arg values first in group
        operands.append(sc.data)
    for a, inv in gc_orders:
        if inv is not None:
            operands.append(inv)  # non-contributing rows sort to group tail
        if a.distinct:
            operands.append(block[a.arg].data)  # duplicates adjacent, value order
    num_sort_keys = len(operands)
    operands.append(jnp.arange(n, dtype=jnp.int32))  # original row index
    # group_concat output order is input-row order: the row index becomes a
    # trailing sort key (full determinism) instead of a mere payload
    nk = num_sort_keys + 1 if gcs else num_sort_keys
    sorted_ops = jax.lax.sort(tuple(operands), num_keys=nk)
    perm = sorted_ops[-1]
    sorted_keys = sorted_ops[:num_group_keys]
    sorted_special = sorted_ops[num_group_keys:num_sort_keys]

    # group boundary: any sort-key differs from the previous row
    neq = jnp.zeros(n, dtype=jnp.bool_)
    for arr in sorted_keys:
        neq = neq | (arr != jnp.roll(arr, 1))
    neq = neq.at[0].set(False)
    gid_sorted = jnp.cumsum(neq.astype(jnp.int32))

    live_sorted = jnp.take(live, perm)
    num_groups = jnp.where(
        jnp.any(live_sorted), jnp.max(jnp.where(live_sorted, gid_sorted, -1)) + 1, 0
    )
    overflow = jnp.where(num_groups > num_slots, num_groups, 0).astype(jnp.int64)
    gids = jnp.where(live_sorted, jnp.minimum(gid_sorted, num_slots), num_slots)

    # permute only the columns the aggregates read — keys are gathered at
    # group starts below (far fewer rows)
    needed = []
    for a in aggs:
        if a.arg is not None and a.arg not in needed:
            needed.append(a.arg)
        if a.filter_col is not None and a.filter_col not in needed:
            needed.append(a.filter_col)
    sorted_block = block.select(needed).take(perm) if needed else Block(
        names=(), columns=(), sel=None
    )
    if in_sort_special:
        a0 = special[0]
        pneq = neq
        for arr in sorted_special:
            pneq = pneq | (arr != jnp.roll(arr, 1))
        pneq = pneq.at[0].set(True)
        if a0.func == "count_distinct":
            dflags = {a0.name: pneq}
        else:  # quantile: target row per group from sorted positions
            q = a0.param if a0.param is not None else 0.5
            pos = jnp.arange(n, dtype=jnp.int64)
            first_of_grp = neq.at[0].set(True)
            from .segments import backward_fill_positions, forward_fill_positions

            start = forward_fill_positions(first_of_grp).astype(jnp.int64)
            valid_s = ~sorted_special[0]
            # per-row group valid-count via cumsum differenced at the
            # per-row group end (backward-filled last flags) — scatter-free
            last_flag = jnp.roll(first_of_grp, -1).at[n - 1].set(True)
            end_row = backward_fill_positions(last_flag).astype(jnp.int64)
            cumv = jnp.cumsum(valid_s.astype(jnp.int64))
            at_end = jnp.take(cumv, end_row.astype(jnp.int32))
            at_prev = jnp.where(
                start > 0, jnp.take(cumv, jnp.maximum(start - 1, 0).astype(jnp.int32)), 0
            )
            cnt_row = at_end - at_prev
            target = start + jnp.floor(
                q * (cnt_row - 1).astype(jnp.float64)
            ).astype(jnp.int64)
            dflags = {a0.name: (pos == target) & valid_s}
    else:
        dflags = _compute_distinct_flags(block, keys, aggs, live)
        dflags = {k: jnp.take(v, perm) for k, v in dflags.items()}

    # group layout for scatter-free segmented reduction + key gathers
    pos32 = jnp.arange(n, dtype=jnp.int32)
    first_of_group = live_sorted & (
        (pos32 == 0) | neq | ~jnp.roll(live_sorted, 1)
    )
    live_next = jnp.concatenate([live_sorted[1:], jnp.zeros(1, jnp.bool_)])
    neq_next = jnp.concatenate([neq[1:], jnp.ones(1, jnp.bool_)])
    last_of_group = live_sorted & (neq_next | ~live_next)
    ends_dense = jnp.full(num_slots + 1, -1, jnp.int32).at[
        jnp.where(last_of_group, gids, num_slots)
    ].set(pos32, mode="drop")[:num_slots]

    acc = _accumulate(aggs, sorted_block, gids, live_sorted, num_slots,
                      sorted_ids=True, distinct_flags=dflags,
                      sorted_layout=(first_of_group, ends_dense))

    # materialize group keys by GATHERING each group's first row (starts =
    # previous group's end + 1; slot 0 starts at row 0) — composed through
    # perm so key columns are never permuted wholesale
    prev_ends = jnp.concatenate([jnp.full((1,), -1, jnp.int32), ends_dense[:-1]])
    starts_dense = jnp.maximum(prev_ends + 1, 0)
    orig_start_idx = jnp.take(perm, starts_dense)
    out_key_cols = []
    for c in key_cols:
        dst = jnp.take(c.data, orig_start_idx)
        vdst = (
            jnp.take(c.validity, orig_start_idx) if c.validity is not None else None
        )
        out_key_cols.append(Column(dst, vdst, c.dtype, c.dictionary))

    occupied = jnp.arange(num_slots, dtype=jnp.int32) < num_groups
    names = tuple(keys) + tuple(n_ for n_, _ in acc)
    cols = tuple(out_key_cols) + tuple(c for _, c in acc)
    out = Block(names=names, columns=cols, sel=occupied)
    return AggregateResult(out, num_groups, overflow)


def _stream_accumulate_batched(
    aggs: Sequence[AggDesc],
    block: Block,
    keys: Sequence[str],
    key_cols: Sequence[Column],
    live: jnp.ndarray,
    first_of_group: jnp.ndarray,
    ends_ok: jnp.ndarray,
    e_idx: jnp.ndarray,
) -> Tuple[List[Tuple[str, Column]], jnp.ndarray]:
    """Stream-agg fast path: ONE packed row gather per dtype class.

    Every per-group quantity is a read of some n-length running array at
    the group's END row: cumulative sums difference against the previous
    group's end (spans are dense, so that is just a shift), resetting
    scans (float sums, min/max) read directly, and key values are
    constant within a group so the end row serves as well as the start.
    One (n, k) packed row gather replaces k separate gathers, which pay
    the per-row gather cost k times.
    """
    n = block.capacity
    reads: List[list] = []  # [source_array, kind('cum'|'direct'), result]

    def req(arr: jnp.ndarray, kind: str) -> int:
        reads.append([arr, kind, None])
        return len(reads) - 1

    live64 = live.astype(jnp.int64)
    h_live = req(jnp.cumsum(live64), "cum")

    # keys (+validities) read directly at the end row
    h_keys = []
    for c in key_cols:
        hv = req(c.validity, "direct") if c.validity is not None else None
        h_keys.append((req(c.data, "direct"), hv))

    def agg_live(a: AggDesc) -> jnp.ndarray:
        if a.filter_col is None:
            return live
        f = block[a.filter_col]
        m = f.data.astype(jnp.bool_)
        if f.validity is not None:
            m = m & f.validity
        return live & m

    # request phase
    plans = []
    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        base = agg_live(a)
        valid_row = base if col is None or col.validity is None else (
            base & col.validity
        )
        plain = a.filter_col is None and (col is None or col.validity is None)
        h_cnt = h_live if plain else req(
            jnp.cumsum(valid_row.astype(jnp.int64)), "cum"
        )
        if a.func == "count":
            plans.append((a, col, {"cnt": h_cnt}))
        elif a.func in ("sum", "avg"):
            acc_dt = FLOAT64 if col.dtype.is_float else INT64
            vals = col.data.astype(acc_dt.jnp_dtype)
            vals = jnp.where(valid_row, vals, _identity_for("sum", acc_dt))
            if acc_dt.is_float:
                from .window import _segmented_prefix

                h_sum = req(_segmented_prefix("sum", vals, first_of_group),
                            "direct")
            else:
                h_sum = req(jnp.cumsum(vals), "cum")
            plans.append((a, col, {"sum": h_sum, "cnt": h_cnt}))
        else:  # min / max
            ident = _identity_for(a.func, col.dtype)
            vals = jnp.where(valid_row, col.data, ident)
            from .window import _segmented_prefix

            h_red = req(_segmented_prefix(a.func, vals, first_of_group),
                        "direct")
            plans.append((a, col, {"red": h_red, "cnt": h_cnt}))

    # execute phase: one packed gather per dtype class
    from collections import defaultdict

    classes = defaultdict(list)
    for i, (arr, _, _) in enumerate(reads):
        cls = "f64" if jnp.issubdtype(arr.dtype, jnp.floating) else "i64"
        classes[cls].append(i)
    for cls, idxs in classes.items():
        tgt = jnp.float64 if cls == "f64" else jnp.int64
        if len(idxs) == 1:
            i = idxs[0]
            reads[i][2] = jnp.take(reads[i][0].astype(tgt), e_idx)
        else:
            stacked = jnp.stack([reads[i][0].astype(tgt) for i in idxs], axis=1)
            got = jnp.take(stacked, e_idx, axis=0)
            for j, i in enumerate(idxs):
                reads[i][2] = got[:, j]

    def resolve(h: int) -> jnp.ndarray:
        arr = reads[h][2]
        if reads[h][1] == "cum":
            prev = jnp.concatenate([jnp.zeros(1, arr.dtype), arr[:-1]])
            return jnp.where(ends_ok, arr - prev, jnp.zeros((), arr.dtype))
        return arr

    live_counts = resolve(h_live)
    occupied = ends_ok & (live_counts > 0)

    out: List[Tuple[str, Column]] = []
    for (name, c), (hd, hv) in zip(zip(keys, key_cols), h_keys):
        data = resolve(hd).astype(c.data.dtype)
        validity = resolve(hv).astype(jnp.bool_) if hv is not None else None
        out.append((name, Column(data, validity, c.dtype, c.dictionary)))

    # finish phase (same result-type rules as _accumulate)
    for a, col, h in plans:
        rdt = agg_result_dtype(a.func, col.dtype if col else None)
        if a.func == "count":
            out.append((a.name, Column(resolve(h["cnt"]), None, INT64)))
            continue
        cnt = resolve(h["cnt"])
        if a.func == "sum":
            sums = resolve(h["sum"])
            scale_shift = rdt.scale - (col.dtype.scale if col.dtype.is_decimal else 0)
            if rdt.is_decimal and scale_shift:
                sums = sums * (10 ** scale_shift)
            out.append((a.name, Column(sums.astype(rdt.jnp_dtype), cnt > 0, rdt)))
        elif a.func == "avg":
            sums = resolve(h["sum"])
            from ..expr.functions import _div_round_half_up

            if rdt.is_decimal:
                src_scale = col.dtype.scale if col.dtype.is_decimal else 0
                num = sums * (10 ** (rdt.scale - src_scale))
                data = _div_round_half_up(num, jnp.maximum(cnt, 1))
            else:
                data = sums / jnp.maximum(cnt, 1).astype(jnp.float64)
            out.append((a.name, Column(data.astype(rdt.jnp_dtype), cnt > 0, rdt)))
        else:  # min / max
            red = resolve(h["red"])
            out.append((a.name, Column(red.astype(rdt.jnp_dtype), cnt > 0,
                                       rdt, col.dictionary)))
    return out, occupied


def aggregate_stream(
    block: Block, keys: Sequence[str], aggs: Sequence[AggDesc], num_slots: int
) -> AggregateResult:
    """Stream aggregation over key-clustered input — NO sort.

    The tipb ``StreamAgg`` analog (``Flash/Planner/PhysicalPlan.cpp``
    handles StreamAgg next to Aggregation): when rows with equal group
    keys are already adjacent (``Block.clustered_by``, e.g. a scan of the
    PK-sorted DeltaTree stable layer), group boundaries come from a
    prev-row compare and reductions use the same scatter-free
    cumsum-at-ends layout as the sort method — the whole O(n log n) sort
    disappears.

    Dead (filtered) rows stay in place: boundaries are detected over ALL
    rows, dead rows contribute nothing via the live mask, and groups with
    no live rows end up unoccupied.  Only equal-adjacency is required —
    full ordering is not.
    """
    n = block.capacity
    live = block.sel_mask()
    key_cols = [block[k] for k in keys]

    neq = jnp.zeros(n, dtype=jnp.bool_)
    for c in key_cols:
        neq = neq | (c.data != jnp.roll(c.data, 1))
        if c.validity is not None:
            neq = neq | (c.validity != jnp.roll(c.validity, 1))
    neq = neq.at[0].set(False)
    gid_all = jnp.cumsum(neq.astype(jnp.int32))  # monotone over ALL rows
    total_groups = gid_all[-1] + 1
    overflow = jnp.where(total_groups > num_slots, total_groups, 0).astype(jnp.int64)
    gids = jnp.minimum(gid_all, num_slots)

    # group layout: spans are contiguous over ALL rows, so slot g's start
    # is slot g-1's end + 1 and slot g's END is the g-th row whose NEXT
    # row opens a new group.  That dense ends table is a flagged-position
    # compaction: ONE single-operand packed sort, cheaper than a
    # sort-method searchsorted(gid_all, slots) (ops/merge.py)
    from .merge import flagged_positions

    first_of_group = neq.at[0].set(True)
    is_end = jnp.concatenate([neq[1:], jnp.ones(1, dtype=jnp.bool_)])
    ends_dense = flagged_positions(is_end, num_slots)

    ends_ok = ends_dense >= 0
    e_idx = jnp.maximum(ends_dense, 0)

    fast = all(a.func in ("sum", "count", "avg", "min", "max") for a in aggs)
    if fast:
        acc, occupied = _stream_accumulate_batched(
            aggs, block, keys, key_cols, live, first_of_group,
            ends_ok, e_idx,
        )
        num_groups = jnp.sum(occupied, dtype=jnp.int32)
        names = tuple(n_ for n_, _ in acc)
        cols = tuple(c for _, c in acc)
        out = Block(names=names, columns=cols, sel=occupied)
        return AggregateResult(out, num_groups, overflow)

    dflags = _compute_distinct_flags(block, keys, aggs, live)

    acc = _accumulate(aggs, block, gids, live, num_slots,
                      sorted_ids=True, distinct_flags=dflags,
                      sorted_layout=(first_of_group, ends_dense),
                      spans_all_live=False)

    # occupied slots = groups with >= 1 live row (cumsum-at-ends, no scatter)
    prev_ends = jnp.concatenate([jnp.full((1,), -1, jnp.int32), ends_dense[:-1]])
    starts_dense = jnp.maximum(prev_ends + 1, 0)
    ps_live = jnp.cumsum(live.astype(jnp.int64))
    at_end = jnp.take(ps_live, e_idx)
    at_prev = jnp.where(starts_dense > 0,
                        jnp.take(ps_live, jnp.maximum(starts_dense - 1, 0)), 0)
    occupied = ends_ok & ((at_end - at_prev) > 0)
    num_groups = jnp.sum(occupied, dtype=jnp.int32)

    # keys gathered at each group's first row (input order — no permute)
    out_key_cols = []
    for c in key_cols:
        dst = jnp.take(c.data, starts_dense)
        vdst = jnp.take(c.validity, starts_dense) if c.validity is not None else None
        out_key_cols.append(Column(dst, vdst, c.dtype, c.dictionary))

    names = tuple(keys) + tuple(n_ for n_, _ in acc)
    cols = tuple(out_key_cols) + tuple(c for _, c in acc)
    out = Block(names=names, columns=cols, sel=occupied)
    return AggregateResult(out, num_groups, overflow)


def _sketch_hashes(block: Block, a: AggDesc) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(62-bit value hashes, live-and-not-null mask) for a sketch agg.
    ``approx_cd_final`` consumes already-hashed candidate rows from the
    partial stage (+inf padding counts as dead)."""
    from .sketch import _INF

    col = block[a.arg]
    live = block.sel_mask()
    if a.filter_col is not None:
        f = block[a.filter_col]
        m = f.data.astype(jnp.bool_)
        if f.validity is not None:
            m = m & f.validity
        live = live & m
    if col.validity is not None:
        live = live & col.validity
    if a.func == "approx_cd_final":
        h = col.data
        return h, live & (h < _INF)
    from .hashing import hash_columns_u63

    return hash_columns_u63([col]), live


def kmv_partial(block: Block, aggs: Sequence[AggDesc]) -> AggregateResult:
    """Partial stage of distributed approx_count_distinct: the sketch AS
    ROWS — a k-row block of candidate hashes per agg.  A passthrough
    exchange concatenates the shards' candidates and ``approx_cd_final``
    re-sketches the union (KMV merge == re-selection).  This replaces the
    reference's serialized uniq-state merge
    (``AggregateFunctionUniq.h: merge``)."""
    from .sketch import SKETCH_K, kmv_candidates

    cols = {}
    # sketch size knob (approx_distinct_sketch_k setting via AggDesc.param);
    # one k per aggregation — Block columns must be equal length
    k = next((int(a.param) for a in aggs if a.param), SKETCH_K)
    for a in aggs:
        h, live = _sketch_hashes(block, a)
        cols[a.name] = Column(kmv_candidates(h, live, k), None, INT64)
    out = Block.from_dict(cols)
    return AggregateResult(out, jnp.int32(k), jnp.int64(0))


_SKETCH_FUNCS = ("approx_count_distinct", "approx_cd_final")


def aggregate_scalar(block: Block, aggs: Sequence[AggDesc]) -> Block:
    """Aggregation without GROUP BY: single-row output (slot 0).

    Uses the masked method (plain fused reductions) whenever possible:
    one streaming pass, no scatter-add."""
    if any(a.func in _SKETCH_FUNCS for a in aggs):
        from .sketch import SKETCH_K, kmv_candidates, kmv_estimate

        rest = [a for a in aggs if a.func not in _SKETCH_FUNCS]
        base = aggregate_scalar(block, rest) if rest else None
        cols: dict = {}
        for a in aggs:
            if a.func not in _SKETCH_FUNCS:
                cols[a.name] = base[a.name]
                continue
            h, live = _sketch_hashes(block, a)
            k = int(a.param) if a.param else SKETCH_K
            est = kmv_estimate(kmv_candidates(h, live, k))
            cols[a.name] = Column(est[None], None, INT64)
        return Block.from_dict(cols)
    live = block.sel_mask()
    gids = jnp.where(live, 0, 1).astype(jnp.int32)
    if _masked_eligible(block, aggs):
        acc, _ = _accumulate_masked(
            aggs, block, jnp.zeros(block.capacity, jnp.int32), live, 1
        )
        return Block(
            names=tuple(n for n, _ in acc),
            columns=tuple(c for _, c in acc),
            sel=None,
        )
    dflags = _compute_distinct_flags(block, [], aggs, live)
    acc = _accumulate(aggs, block, gids, live, 1, sorted_ids=False,
                      distinct_flags=dflags)
    names = tuple(n for n, _ in acc)
    cols = tuple(c for _, c in acc)
    return Block(names=names, columns=cols, sel=None)


def passthrough_as_partial(block: Block, keys: Sequence[str], aggs: Sequence[AggDesc]) -> Block:
    """Map raw rows into partial-aggregate shape (each live row its own
    'group'): sum->value, count->0/1, min/max->value.  Used by the
    auto-passthrough path; the final aggregation merges these like any
    other partials."""
    cols = {k: block[k] for k in keys}
    live = block.sel_mask()
    for a in aggs:
        col = block[a.arg] if a.arg is not None else None
        rdt = agg_result_dtype(a.func, col.dtype if col else None)
        if a.func == "count":
            ones = live.astype(jnp.int64)
            if col is not None and col.validity is not None:
                ones = ones * col.validity.astype(jnp.int64)
            cols[a.name] = Column(ones, None, INT64)
        elif a.func == "sum":
            acc_dt = FLOAT64 if col.dtype.is_float else INT64
            data = col.data.astype(acc_dt.jnp_dtype)
            validity = col.validity
            cols[a.name] = Column(data.astype(rdt.jnp_dtype), validity, rdt)
        elif a.func in ("min", "max"):
            cols[a.name] = Column(
                col.data.astype(rdt.jnp_dtype), col.validity, rdt, col.dictionary
            )
        elif a.func in _BIT_FUNCS:
            ident = _bit_identity(a.func)
            u = col.data.astype(jnp.uint64)
            if col.validity is not None:
                u = jnp.where(col.validity, u, ident)
            cols[a.name] = Column(u, None, rdt)
        else:
            raise NotImplementedError(f"passthrough for {a.func} (decompose avg first)")
    return Block.from_dict(cols, sel=block.sel)


def auto_passthrough_aggregate(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    passthrough_ratio: float = 0.5,
) -> AggregateResult:
    """Adaptive first-stage aggregation (reference
    ``Operators/AutoPassThroughHashAggContext.h:50``, design
    ``docs/design/2024-08-07-auto-pass-through-hashagg.md``).

    The reference observes NDV batch-by-batch and switches states
    (Init/Adjust/PreAgg/PassThrough); in one shape-static program we
    compute the partial aggregate AND the passthrough form, then select by
    the observed group ratio with ``jnp.where`` — high-cardinality inputs
    flow through unreduced (so the shuffle isn't preceded by a useless
    hash agg), low-cardinality inputs shrink before exchange.  Only
    meaningful ahead of an exchange; requires avg already decomposed."""
    rw = _wide_rewrite(block, aggs)
    post = None
    if rw is not None:
        block, aggs, post = rw

    def fin(res: AggregateResult) -> AggregateResult:
        if post is None:
            return res
        return AggregateResult(post(res.block), res.num_groups, res.overflow)

    if not keys:
        b = aggregate_scalar(block, aggs)
        return fin(AggregateResult(b, jnp.int32(1), jnp.int64(0)))
    key_cols = [block[k] for k in keys]
    packed = pack_keys_direct(key_cols)
    if packed is not None and packed[1] <= DIRECT_DOMAIN_LIMIT:
        # tiny domain: always aggregate, never pass through
        return fin(aggregate_direct(block, keys, aggs, packed))
    n = block.capacity
    n_live = block.num_rows()

    # cheap NDV estimate on a strided sample (the batch-observation analog)
    sample_n = min(2048, n)
    stride = max(1, n // sample_n)
    idx = jnp.arange(sample_n, dtype=jnp.int32) * stride
    from .hashing import hash_columns

    h = hash_columns(key_cols)
    hs = jnp.take(h, idx)
    live_s = jnp.take(block.sel_mask(), idx)
    hs = jnp.where(live_s, hs, jnp.uint32(0xFFFFFFFF))
    hs_sorted = jnp.sort(hs)
    uniq = jnp.sum(
        ((hs_sorted != jnp.roll(hs_sorted, 1)).at[0].set(True))
        & (hs_sorted != jnp.uint32(0xFFFFFFFF))
    )
    n_sample_live = jnp.maximum(jnp.sum(live_s), 1)
    use_pass = uniq.astype(jnp.float64) > passthrough_ratio * n_sample_live.astype(jnp.float64)

    # both branches emit the identical pytree (data, validity-materialized,
    # sel, groups) — lax.cond executes only one at runtime
    def norm(b: Block):
        datas = tuple(c.data for c in b.columns)
        valids = tuple(c.valid_mask() for c in b.columns)
        return datas, valids, b.sel_mask()

    agg_names = list(keys) + [a.name for a in aggs]

    def agg_branch(_):
        res = aggregate_sort(block, keys, aggs, num_slots=n)
        d, v, s = norm(res.block)
        return d, v, s, res.num_groups.astype(jnp.int64)

    def pass_branch(_):
        pb = passthrough_as_partial(block, keys, aggs).select(agg_names)
        d, v, s = norm(pb)
        return d, v, s, n_live.astype(jnp.int64)

    d, v, s, groups = jax.lax.cond(use_pass, pass_branch, agg_branch, None)
    # reconstruct with agg-result schema (dtypes identical across branches
    # by construction of passthrough_as_partial)
    ref_res_schema = [
        (k, block[k].dtype, block[k].dictionary) for k in keys
    ] + [
        (
            a.name,
            agg_result_dtype(a.func, block[a.arg].dtype if a.arg else None),
            (block[a.arg].dictionary if a.arg and a.func in ("min", "max") else None),
        )
        for a in aggs
    ]
    cols = tuple(
        Column(dd, vv, dt_, dic)
        for dd, vv, (name, dt_, dic) in zip(d, v, ref_res_schema)
    )
    out = Block(names=tuple(agg_names), columns=cols, sel=s)
    return fin(AggregateResult(out, groups, jnp.int64(0)))


def hash_aggregate(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    num_slots: Optional[int] = None,
) -> AggregateResult:
    """Method dispatch (the ``chooseAggregationMethod`` analog)."""
    # MySQL coerces temporal args of bit aggregates to their NUMERIC form
    # (TIME 11:11:35 -> 111135, like CAST(.. AS SIGNED)) before the bit op
    from ..core.dtypes import TypeKind as _TK

    for a in aggs:
        if a.func in _BIT_FUNCS and a.arg in block.names:
            c = block[a.arg]
            if c.dtype.kind in (_TK.DATE, _TK.DATETIME, _TK.DURATION):
                from ..expr.functions import cast_column
                from ..core.dtypes import INT64 as _I64

                block = block.with_column(
                    a.arg, cast_column(c, _I64.with_nullable(
                        c.dtype.nullable)))
    rw = _wide_rewrite(block, aggs)
    if rw is not None:
        block, aggs, post = rw
        res = _dispatch_aggregate(block, keys, aggs, num_slots)
        return AggregateResult(post(res.block), res.num_groups, res.overflow)
    return _dispatch_aggregate(block, keys, aggs, num_slots)


def _dispatch_aggregate(
    block: Block,
    keys: Sequence[str],
    aggs: Sequence[AggDesc],
    num_slots: Optional[int] = None,
) -> AggregateResult:
    if keys and any(a.func == "approx_count_distinct" for a in aggs):
        # grouped approx distinct: groups are co-located (exchange shuffles
        # by key — plan/distribute._COLOCATE), so the exact sorted-flag
        # path is available and "approximate" may legally be exact
        aggs = [dataclasses.replace(a, func="count_distinct")
                if a.func == "approx_count_distinct" else a for a in aggs]
    if not keys:
        if aggs and all(a.func == "approx_cd_partial" for a in aggs):
            return kmv_partial(block, aggs)
        b = aggregate_scalar(block, aggs)
        return AggregateResult(b, jnp.int32(1), jnp.int64(0))
    key_cols = [block[k] for k in keys]
    if any(a.func == "group_concat" for a in aggs):
        # group_concat needs the sorted contiguous-span layout
        return aggregate_sort(block, keys, aggs, num_slots or block.capacity)
    packed = pack_keys_direct(key_cols)
    if packed is not None and packed[1] <= DIRECT_DOMAIN_LIMIT:
        if (any(a.func in _BIT_FUNCS for a in aggs)
                and (packed[1] > MASKED_DOMAIN_LIMIT
                     or not _masked_eligible(block, aggs))):
            # bit reductions have no segment form: masked method
            # for tiny eligible domains, sorted segmented scan otherwise
            # (e.g. mixed with count_distinct, which masked can't do)
            return aggregate_sort(block, keys, aggs,
                                  num_slots or block.capacity)
        return aggregate_direct(block, keys, aggs, packed)
    if num_slots is None:
        num_slots = block.capacity
    cb = block.clustered_by
    if cb and len(keys) <= len(cb) and set(keys) == set(cb[: len(keys)]):
        # equal group keys are already adjacent: StreamAgg, no sort
        return aggregate_stream(block, keys, aggs, num_slots)
    return aggregate_sort(block, keys, aggs, num_slots)


__all__ = [
    "AggDesc",
    "AggregateResult",
    "hash_aggregate",
    "aggregate_direct",
    "aggregate_sort",
    "aggregate_stream",
    "aggregate_scalar",
    "auto_passthrough_aggregate",
    "passthrough_as_partial",
    "agg_result_dtype",
    "pack_keys_direct",
    "DIRECT_DOMAIN_LIMIT",
]
