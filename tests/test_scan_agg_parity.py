"""scan -> filter -> project -> aggregate chains vs the plan oracle.

Role analog: the reference's aggregation gtests
(``Interpreters/tests/gtest_aggregator.cpp``) for the direct methods: both
routes for TPC-H Q1/Q6-shaped chains must match the independent python
oracle, including NULL propagation through arithmetic with constants and
sums whose bound passes int64:

- plain: masked fused reductions for tiny key domains, the segment path
  above them (``ops/aggregate.py``);
- fused: the fused scan-aggregate kernel (``ops/scan_agg.py``) in Pallas'
  interpreter, for the chains it covers; the others take the plain route.
"""

import numpy as np
import pytest

from tiflash_jax.core.block import Block, column_from_numpy
from tiflash_jax.core.dtypes import DATE, Decimal, INT64, STRING
from tiflash_jax.expr.nodes import Call, ColumnRef, Literal
from tiflash_jax.ops import scan_agg as SA
from tiflash_jax.ops.aggregate import MASKED_DOMAIN_LIMIT, AggDesc
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle


@pytest.fixture(params=["plain", "fused"])
def route(request, monkeypatch):
    """'fused' runs the kernel in interpret mode and counts its calls."""
    calls = []
    if request.param == "fused":
        real = SA._tile_lane_sums

        def spy(cols, n, tile_fn, domain, n_lanes, interpret):
            if interpret:  # a run, not the lowering probe
                calls.append(1)
            return real(cols, n, tile_fn, domain, n_lanes, interpret)

        monkeypatch.setattr(SA, "kernel_route", lambda: "interpret")
        monkeypatch.setattr(SA, "_tile_lane_sums", spy)
    return request.param, calls


def _run_parity(plan, tables, route, fused=True):
    """``fused``: whether the kernel covers this chain."""
    out, overflows = compile_fragment(plan)(tables)
    for k, v in overflows.items():
        assert not bool(v), f"overflow at {k}"
    name, calls = route
    assert len(calls) == (1 if name == "fused" and fused else 0)
    calls.clear()
    got = O.block_to_pytable(out)
    pytables = {n: O.block_to_pytable(b) for n, b in tables.items()}
    want = execute_plan_oracle(plan, pytables)
    O.assert_tables_equal(got, want, ordered=False)
    return got


def _mktable(n=1000, nulls=False, seed=0, n_groups=None):
    rng = np.random.default_rng(seed)
    names = (["aa", "bb", "cc", "dd"] if n_groups is None
             else [f"g{i:03d}" for i in range(n_groups)])
    grp = rng.choice(names, size=n).tolist()
    qty = rng.integers(1, 51, size=n) * 100          # Decimal(15,2)
    price = rng.integers(90_000, 10_500_000, size=n)  # Decimal(15,2)
    disc = rng.integers(0, 11, size=n)                # Decimal(15,2) 0.00-0.10
    day = rng.integers(9000, 11000, size=n)           # DATE days
    flag = rng.choice(["X", "Y"], size=n).tolist()
    vd = rng.random(n) > 0.3 if nulls else None
    vq = rng.random(n) > 0.2 if nulls else None
    cols = {
        "grp": column_from_numpy(grp, STRING),
        "qty": column_from_numpy(qty, Decimal(15, 2, nullable=nulls),
                                 validity=vq),
        "price": column_from_numpy(price, Decimal(15, 2)),
        "disc": column_from_numpy(disc, Decimal(15, 2, nullable=nulls),
                                  validity=vd),
        "day": column_from_numpy(day, DATE),
        "flag": column_from_numpy(flag, STRING),
    }
    return {"t": Block.from_dict(cols)}


def _q1_like(keys=("grp",)):
    disc_price = Call("multiply", (
        ColumnRef("price"),
        Call("minus", (Literal(1), ColumnRef("disc"))),
    ))
    proj = P.Projection(
        exprs={
            "grp": ColumnRef("grp"),
            "qty": ColumnRef("qty"),
            "price": ColumnRef("price"),
            "disc": ColumnRef("disc"),
            "dp": disc_price,
        },
        child=P.Selection(
            cond=Call("less_or_equals", (ColumnRef("day"),
                                         Literal("1998-09-20"))),
            child=P.TableScan("t"),
        ),
    )
    return P.Aggregation(
        keys=list(keys),
        aggs=[
            AggDesc("sum", "qty", "sum_qty"),
            AggDesc("sum", "dp", "sum_dp"),
            AggDesc("avg", "price", "avg_price"),
            AggDesc("avg", "disc", "avg_disc"),
            AggDesc("count", "disc", "cnt_disc"),
            AggDesc("count", None, "cnt"),
        ],
        child=proj,
    )


def test_scan_filter_project_agg_parity(route):
    _run_parity(_q1_like(), _mktable(), route)


def test_null_propagation_through_projection(route):
    """NULL args: sum/avg skip NULL rows; const parts of (1 - disc) must not
    leak into sums on NULL-disc rows; count(disc) counts non-null only."""
    _run_parity(_q1_like(), _mktable(nulls=True, seed=3), route,
                fused=False)  # nullable scanned columns: plain route


def test_two_keys_and_in_filter(route):
    plan = P.Aggregation(
        keys=["grp", "flag"],
        aggs=[AggDesc("sum", "price", "s"), AggDesc("count", None, "c")],
        child=P.Selection(
            cond=Call("and", (
                Call("in", (ColumnRef("grp"), Literal("aa"), Literal("cc"),
                            Literal("zz"))),
                Call("greater", (ColumnRef("qty"), Literal(10))),
            )),
            child=P.TableScan("t"),
        ),
    )
    _run_parity(plan, _mktable(seed=5), route)


def test_string_compare_nonmember_literal(route):
    plan = P.Aggregation(
        keys=["flag"],
        aggs=[AggDesc("count", None, "c")],
        child=P.Selection(
            cond=Call("greater_or_equals", (ColumnRef("grp"), Literal("bz"))),
            child=P.TableScan("t"),
        ),
    )
    _run_parity(plan, _mktable(seed=6), route)


def test_static_out_of_range_literal(route):
    """Literal above every value in the column: statically decided filter."""
    plan = P.Aggregation(
        keys=["grp"],
        aggs=[AggDesc("sum", "qty", "s")],
        child=P.Selection(
            cond=Call("less", (ColumnRef("price"), Literal(10 ** 13))),
            child=P.TableScan("t"),
        ),
    )
    _run_parity(plan, _mktable(seed=7), route)


def test_empty_selection(route):
    plan = P.Aggregation(
        keys=["grp"],
        aggs=[AggDesc("sum", "qty", "s"), AggDesc("count", None, "c")],
        child=P.Selection(
            cond=Call("greater", (ColumnRef("qty"), Literal(10 ** 9))),
            child=P.TableScan("t"),
        ),
    )
    _run_parity(plan, _mktable(seed=8), route)


def test_no_keys_q6_like(route):
    revenue = Call("multiply", (ColumnRef("price"), ColumnRef("disc")))
    plan = P.Aggregation(
        keys=[],
        aggs=[AggDesc("sum", "rev", "revenue"), AggDesc("count", None, "c")],
        child=P.Projection(
            exprs={"rev": revenue},
            child=P.Selection(
                cond=Call("and", (
                    Call("greater_or_equals", (ColumnRef("disc"),
                                               Literal(0.02))),
                    Call("less", (ColumnRef("qty"), Literal(30))),
                )),
                child=P.TableScan("t"),
            ),
        ),
    )
    _run_parity(plan, _mktable(seed=9), route)


def _drop_stats(tables):
    import dataclasses

    t = tables["t"]
    cols = tuple(dataclasses.replace(c, stats=None) for c in t.columns)
    return {"t": dataclasses.replace(t, columns=cols)}


@pytest.mark.parametrize("case", ["many_rows", "large_domain", "missing_stats"])
def test_chain_shapes(case, route):
    """Many rows through the Q1 shape; a key domain above the masked
    limit (the segment path); columns without range stats."""
    if case == "many_rows":
        _run_parity(_q1_like(), _mktable(n=5 * 8192 - 7, seed=12), route)
        return
    plan = P.Aggregation(
        keys=["grp"],
        aggs=[AggDesc("sum", "qty", "s"), AggDesc("count", None, "c")],
        child=P.TableScan("t"),
    )
    if case == "large_domain":
        tables = _mktable(seed=10, n_groups=300)
        assert len(tables["t"]["grp"].dictionary) > MASKED_DOMAIN_LIMIT
    else:
        tables = _drop_stats(_mktable(seed=11))
    _run_parity(plan, tables, route, fused=case != "large_domain")


def test_tpch_q1_q6_parity(route):
    from tiflash_jax.bench.tpch_queries import q1_plan, q6_plan
    from tiflash_jax.storage.tpch import generate_tpch

    cat = generate_tpch(sf=0.002, seed=2)
    tables = cat.blocks()
    for plan in (q1_plan(), q6_plan()):
        _run_parity(plan, tables, route)


def test_sums_past_int64(route):
    """Sums whose bound exceeds int64 come out as two-limb wide decimals
    (SF10+ scale: Q1's sum(charge) bound is rows * ~1.3e11 > 2^62).
    Values near 2^47 at 2^18 rows trip the same guard at test size."""
    rng = np.random.default_rng(4)
    n = 1 << 18
    big = rng.integers(1 << 47, 1 << 48, size=n)  # mantissa ~2e14
    grp = rng.choice(["aa", "bb", "cc"], size=n).tolist()
    cols = {
        "grp": column_from_numpy(grp, STRING),
        "big": column_from_numpy(big, Decimal(17, 2)),
    }
    tables = {"t": Block.from_dict(cols)}
    plan = P.Aggregation(
        keys=["grp"],
        aggs=[AggDesc("sum", "big", "s"), AggDesc("avg", "big", "a"),
              AggDesc("count", None, "n")],
        child=P.TableScan("t"),
    )
    got = _run_parity(plan, tables, route)
    # sanity: at least one group's sum really exceeds int64
    assert any(abs(v) > (1 << 63) for v in
               [int(x.scaleb(2)) for x in got["s"]])


def test_lane_sums_across_programs_and_tail(monkeypatch):
    """Several programs and a ragged last one: the kernel's per-(slot,
    lane) sums equal numpy's."""
    import jax.numpy as jnp

    from tiflash_jax.core.dtypes import INT32

    monkeypatch.setattr(SA, "CHUNK_ROWS", 256)
    rng = np.random.default_rng(21)
    n, domain = 1000, 5
    k = rng.integers(0, domain, n).astype(np.int32)
    v = rng.integers(-(2**40), 2**40, n)
    cols = {"k": column_from_numpy(k, INT32), "v": column_from_numpy(v, INT64)}

    def tile_fn(tile, inb):
        val = tile["v"].data
        return (tile["k"].data, val % 3 != 0,
                [jnp.ones_like(val), val])

    got = np.asarray(SA._tile_lane_sums(cols, n, tile_fn, domain, 2, True))
    live = v % 3 != 0
    for s in range(domain):
        m = live & (k == s)
        assert got[s].tolist() == [int(m.sum()), int(v[m].sum())]


def test_kernel_route_off_without_a_gpu():
    assert SA.kernel_route() is None


@pytest.mark.parametrize("slots", [SA.MAX_ACCUMULATORS,
                                   SA.MAX_ACCUMULATORS + 1])
def test_accumulator_cap(slots, route):
    """A count over ``slots`` groups keeps one accumulator per slot: the
    kernel takes it up to the cap, the plain path above it."""
    plan = P.Aggregation(keys=["grp"], aggs=[AggDesc("count", None, "c")],
                         child=P.TableScan("t"))
    tables = _mktable(n=2000, seed=13, n_groups=slots)
    assert len(tables["t"]["grp"].dictionary) == slots
    _run_parity(plan, tables, route, fused=slots <= SA.MAX_ACCUMULATORS)


def test_tpch_q1_sf10_fills_the_accumulator_cap():
    """The cap is Q1's own size at SF10 (59,996,881 lineitem rows): 6
    (returnflag, linestatus) slots x 9 lanes, since at that row count the
    int64 exactness proof fails for two sums and each splits into two
    digit lanes."""
    from tiflash_jax.bench.tpch_queries import q1_plan
    from tiflash_jax.ops.aggregate import _wide_rewrite, pack_keys_direct
    from tiflash_jax.plan.compiler import execute_plan
    from tiflash_jax.storage.tpch import generate_tpch

    agg = q1_plan()
    while not isinstance(agg, P.Aggregation):
        agg = agg.child
    tables = generate_tpch(sf=0.001, seed=3, tables=["lineitem"]).blocks()
    block = execute_plan(agg.child, tables)
    block, aggs, _ = _wide_rewrite(block, list(agg.aggs), rows=59_996_881)
    domain = pack_keys_direct([block[k] for k in agg.keys])[1]
    assert (domain, len(SA._lanes(aggs, block))) == (6, 9)
    assert domain * 9 == SA.MAX_ACCUMULATORS


@pytest.mark.parametrize("body", ["plain", "sort", "table_lookup"])
def test_triton_lowering_probe(body):
    """The kernel is tried for the GPU before it is used: operations the
    Triton lowering lacks, and arrays the kernel closes over, send the
    chain to the plain path."""
    import jax.numpy as jnp

    from tiflash_jax.core.dtypes import INT32

    table = np.arange(7, dtype=np.int64)
    k = np.arange(500, dtype=np.int32) % 3
    cols = {"k": column_from_numpy(k, INT32),
            "v": column_from_numpy(np.arange(500), INT64)}

    def tile_fn(tile, inb):
        v = tile["v"].data
        if body == "sort":
            v = jnp.sort(v)
        elif body == "table_lookup":
            v = jnp.asarray(table)[v % 7]
        return tile["k"].data, inb, [jnp.ones_like(v), v]

    assert SA._lowers(cols, 500, tile_fn, 3, 2) == (body == "plain")
