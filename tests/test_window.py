"""Window-function parity tests (engine vs oracle).

Role analog: ``Flash/tests/gtest_window_executor.cpp``.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.ops.window import WindowDesc, window_block
from tiflash_jax.testing import oracle as O

SCHEMA = {
    "p": dt.INT32,
    "o": dt.INT64,
    "v": dt.INT64.with_nullable(True),
    "d": dt.Decimal(10, 2),
    "s": dt.STRING.with_nullable(True),
}


def run(funcs, seed=0, n=300, order_desc=False):
    rng = np.random.default_rng(seed)
    table = O.random_pytable(rng, n, SCHEMA, int_range=(0, 12))
    block = O.pytable_to_block(table, SCHEMA)
    order = [SortKey("o", desc=order_desc, nulls_first=not order_desc)]
    out = window_block(block, ["p"], order, funcs)
    got = O.block_to_pytable(out)
    want = O.o_window(table, ["p"], [("o", order_desc)], funcs)
    # peer-group ties make full row order ambiguous; compare as sorted rows
    O.assert_tables_equal(got, want)


def test_row_number_rank_dense_rank():
    run([
        WindowDesc("row_number", "rn"),
        WindowDesc("rank", "rk"),
        WindowDesc("dense_rank", "dr"),
    ])


def test_lead_lag():
    run([
        WindowDesc("lag", "lg", arg="v", offset=1),
        WindowDesc("lead", "ld", arg="v", offset=2),
        WindowDesc("lag", "lgd", arg="v", offset=1, default=-1),
    ])


def test_first_last_value():
    run([
        WindowDesc("first_value", "fv", arg="d"),
        WindowDesc("last_value", "lv", arg="d"),
    ])


def test_running_aggregates():
    run([
        WindowDesc("sum", "rs", arg="v"),
        WindowDesc("count", "rc", arg="v"),
        WindowDesc("count", "rcs"),
        WindowDesc("min", "rmn", arg="d"),
        WindowDesc("max", "rmx", arg="d"),
    ])


def _constant_cumulative_ops(jaxpr, dep_in) -> list:
    """Cumulative ops (cumsum, cummax, ...) whose operand depends on no
    input of ``jaxpr``."""
    from jax.extend.core import ClosedJaxpr, Jaxpr, Var

    dep = {v for v, d in zip(jaxpr.invars, dep_in) if d}
    found = []
    for eqn in jaxpr.eqns:
        ins = [isinstance(a, Var) and a in dep for a in eqn.invars]
        if eqn.primitive.name.startswith("cum") and not any(ins):
            found.append(eqn.primitive.name)
        for p in eqn.params.values():
            sub = p.jaxpr if isinstance(p, ClosedJaxpr) else p
            if isinstance(sub, Jaxpr):
                sub_in = (ins if len(sub.invars) == len(ins)
                          else [any(ins)] * len(sub.invars))
                found += _constant_cumulative_ops(sub, sub_in)
        if any(ins):
            dep.update(eqn.outvars)
    return found


@pytest.mark.parametrize("funcs", [
    [WindowDesc("row_number", "rn"), WindowDesc("sum", "rs", arg="v")],
    [WindowDesc("count", "rc"), WindowDesc("avg", "fa", arg="v", frame=(2, 0))],
    [WindowDesc("min", "fm", arg="v", frame=(2, 1))],
])
def test_no_cumulative_op_over_constants(funcs):
    """Running counts of NULL-free rows are an iota, never a cumsum of a
    constant: XLA's GPU compiler folds such a cumsum at compile time, in
    time quadratic in the row count (minutes at a few million rows)."""
    import jax

    schema = {"p": dt.INT32, "o": dt.INT64, "v": dt.INT64}
    table = O.random_pytable(np.random.default_rng(4), 64, schema,
                             int_range=(0, 5))
    block = O.pytable_to_block(table, schema)
    closed = jax.make_jaxpr(
        lambda b: window_block(b, ["p"], [SortKey("o")], funcs))(block)
    assert _constant_cumulative_ops(
        closed.jaxpr, [True] * len(closed.jaxpr.invars)) == []


def test_window_desc_order():
    run([WindowDesc("row_number", "rn"), WindowDesc("sum", "rs", arg="d")],
        order_desc=True, seed=3)


def test_window_with_selection():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    table = O.random_pytable(rng, 200, SCHEMA, int_range=(0, 6))
    block = O.pytable_to_block(table, SCHEMA)
    mask = np.asarray(rng.random(200) < 0.6)
    block = block.and_sel(jnp.asarray(mask))
    out = window_block(
        block, ["p"], [SortKey("o")], [WindowDesc("row_number", "rn")]
    )
    got = O.block_to_pytable(out)
    ftable = {k: [x for x, m in zip(v, mask) if m] for k, v in table.items()}
    want = O.o_window(ftable, ["p"], [("o", False)], [WindowDesc("row_number", "rn")])
    O.assert_tables_equal(got, want)


def test_distributed_window():
    import jax
    from jax.sharding import Mesh

    from tiflash_jax.mpp.runner import (
        collect_result, compile_distributed, shard_catalog_blocks,
    )
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.distribute import partitioned_window

    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    rng = np.random.default_rng(6)
    table = O.random_pytable(rng, 320, SCHEMA, int_range=(0, 10))
    blocks = shard_catalog_blocks({"t": O.pytable_to_block(table, SCHEMA)}, mesh)
    funcs = [WindowDesc("row_number", "rn"), WindowDesc("sum", "rs", arg="v")]
    plan = partitioned_window(["p"], [SortKey("o")], funcs, P.TableScan("t"))
    fn = compile_distributed(plan, mesh)
    out, ov = fn(blocks)
    assert not any(bool(np.asarray(v).max()) for v in ov.values())
    got = O.block_to_pytable(collect_result(out))
    want = O.o_window(table, ["p"], [("o", False)], funcs)
    O.assert_tables_equal(got, want)


def test_bounded_rows_frames():
    """ROWS BETWEEN n PRECEDING AND m FOLLOWING for sum/count/avg."""
    run([
        WindowDesc("sum", "fs", arg="v", frame=(1, 1)),
        WindowDesc("count", "fc", arg="v", frame=(2, 0)),
        WindowDesc("avg", "fa", arg="d", frame=(0, 2)),
        WindowDesc("sum", "fw", arg="d", frame=(100, 100)),
    ], seed=8)


def test_ntile_percent_rank_cume_dist():
    run([
        WindowDesc("ntile", "nt", offset=3),
        WindowDesc("percent_rank", "pr"),
        WindowDesc("cume_dist", "cd"),
    ], seed=9)


def test_bounded_rows_frames_min_max():
    """ROWS-frame min/max via the sparse-table (doubling) RMQ path."""
    run([
        WindowDesc("min", "fmn", arg="v", frame=(2, 1)),
        WindowDesc("max", "fmx", arg="v", frame=(1, 2)),
        WindowDesc("min", "fmd", arg="d", frame=(0, 3)),
        WindowDesc("max", "fwide", arg="d", frame=(64, 64)),
        WindowDesc("min", "fpoint", arg="v", frame=(0, 0)),
    ], seed=10)


def test_bounded_rows_frames_min_max_string():
    """Frame min/max on dictionary strings (codes are order-preserving)."""
    run([
        WindowDesc("min", "smin", arg="s", frame=(3, 0)),
        WindowDesc("max", "smax", arg="s", frame=(2, 2)),
    ], seed=11)


def test_range_frames_basic():
    """RANGE BETWEEN x PRECEDING AND y FOLLOWING (value distance on the
    single numeric order key; reference WindowTransformAction.h:122-146)."""
    run([
        WindowDesc("sum", "rs", arg="v", frame=(3, 3), frame_type="range"),
        WindowDesc("count", "rc", arg="v", frame=(2, 0), frame_type="range"),
        WindowDesc("avg", "ra", arg="d", frame=(0, 4), frame_type="range"),
        WindowDesc("min", "rmn", arg="v", frame=(5, 1), frame_type="range"),
        WindowDesc("max", "rmx", arg="d", frame=(1, 5), frame_type="range"),
    ], seed=20)


def test_range_frames_desc_and_current_row():
    """DESC order: value windows flip direction; 0 offsets = peers."""
    run([
        WindowDesc("sum", "rs", arg="v", frame=(4, 2), frame_type="range"),
        WindowDesc("count", "rc", None, frame=(0, 0), frame_type="range"),
        WindowDesc("sum", "peers", arg="v", frame=(0, 0), frame_type="range"),
    ], seed=21, order_desc=True)


def test_range_frames_unbounded_sides():
    """None bounds: UNBOUNDED PRECEDING / FOLLOWING mixed with offsets."""
    run([
        WindowDesc("sum", "ub1", arg="v", frame=(None, 2), frame_type="range"),
        WindowDesc("sum", "ub2", arg="v", frame=(3, None), frame_type="range"),
        WindowDesc("min", "ub3", arg="v", frame=(None, 0), frame_type="range"),
        WindowDesc("count", "ub4", arg="v", frame=(None, None)),
    ], seed=22)


def test_range_frames_nullable_order_key():
    """NULL order keys form their own peer frame (MySQL RANGE semantics)."""
    schema = dict(SCHEMA)
    schema["o"] = dt.INT64.with_nullable(True)
    rng = np.random.default_rng(23)
    table = O.random_pytable(rng, 250, schema, int_range=(0, 9))
    block = O.pytable_to_block(table, schema)
    order = [SortKey("o", desc=False, nulls_first=True)]
    funcs = [
        WindowDesc("sum", "rs", arg="v", frame=(2, 2), frame_type="range"),
        WindowDesc("count", "rc", arg="v", frame=(1, 0), frame_type="range"),
    ]
    out = window_block(block, ["p"], order, funcs)
    got = O.block_to_pytable(out)
    want = O.o_window(table, ["p"], [("o", False)], funcs)
    O.assert_tables_equal(got, want)


def test_nth_value():
    run([
        WindowDesc("nth_value", "n1", arg="d", offset=1),
        WindowDesc("nth_value", "n3", arg="d", offset=3),
        WindowDesc("nth_value", "nv", arg="v", offset=2),
    ])


def test_nth_value_with_frame():
    run([
        WindowDesc("nth_value", "nf", arg="d", offset=2, frame=(1, 1)),
        WindowDesc("nth_value", "nu", arg="d", offset=4, frame=(None, None)),
    ])
