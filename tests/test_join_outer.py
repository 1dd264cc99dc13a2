"""Right/full-outer joins at the plan layer — matched pass + non-matched
build tail (reference ``ScanHashMapAfterProbeBlockInputStream``), single
device and distributed hash-shuffle.
"""

import numpy as np
import pytest

from tiflash_jax.core.block import Block, column_from_numpy
from tiflash_jax.core.dtypes import INT64, STRING
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle


def _tables(string_keys=False, nulls=True):
    lk = [1, 2, 2, 3, 5, 7, 7]
    lv = [10, 20, 21, 30, 50, 70, 71]
    rk = [2, 3, 3, 4, 6, 7]
    rv = [200, 300, 301, 400, 600, 700]
    lval = [True] * len(lk)
    rval = [True] * len(rk)
    if nulls:
        lval[4] = False   # probe NULL key
        rval[3] = False   # build NULL key
    if string_keys:
        enc = lambda xs: ["k%d" % x for x in xs]
        kt = STRING
        lkc = column_from_numpy(enc(lk), kt.with_nullable(nulls),
                                validity=lval if nulls else None)
        rkc = column_from_numpy(enc(rk), kt.with_nullable(nulls),
                                validity=rval if nulls else None)
    else:
        lkc = column_from_numpy(lk, INT64.with_nullable(nulls),
                                validity=lval if nulls else None)
        rkc = column_from_numpy(rk, INT64.with_nullable(nulls),
                                validity=rval if nulls else None)
    left = Block.from_dict({"k": lkc, "lv": column_from_numpy(lv, INT64)})
    right = Block.from_dict({"k": rkc, "rv": column_from_numpy(rv, INT64)})
    return {"l": left, "r": right}


def _run(plan, tables, check_overflow=True):
    out, overflows = compile_fragment(plan)(tables)
    if check_overflow:
        for k, v in overflows.items():
            assert not bool(v), f"overflow at {k}"
    got = O.block_to_pytable(out)
    pytables = {n: O.block_to_pytable(b) for n, b in tables.items()}
    want = execute_plan_oracle(plan, pytables)
    O.assert_tables_equal(got, want, ordered=False)
    return got


@pytest.mark.parametrize("kind", ["right_outer", "full_outer"])
@pytest.mark.parametrize("string_keys", [False, True])
def test_outer_general_path(kind, string_keys):
    tables = _tables(string_keys=string_keys)
    plan = P.Join(
        kind=kind, probe_keys=["k"], build_keys=["k"],
        probe=P.TableScan("l"), build=P.TableScan("r"),
        output_capacity=64,
    )
    got = _run(plan, tables)
    # sanity: build row 4 (NULL key) and 6 (no probe match) are in the tail
    assert 600 in got["rv"]
    assert 400 in got["rv"]


@pytest.mark.parametrize("kind", ["right_outer", "full_outer"])
def test_outer_unique_build(kind):
    tables = _tables()
    # make build keys unique
    rk = [2, 3, 4, 6, 7]
    rv = [200, 300, 400, 600, 700]
    right = Block.from_dict({
        "k": column_from_numpy(rk, INT64),
        "rv": column_from_numpy(rv, INT64),
    })
    tables["r"] = right
    plan = P.Join(
        kind=kind, probe_keys=["k"], build_keys=["k"],
        probe=P.TableScan("l"), build=P.TableScan("r"),
        unique_build=True,
    )
    _run(plan, tables)


def test_full_outer_no_nulls_all_matched():
    tables = _tables(nulls=False)
    plan = P.Join(
        kind="full_outer", probe_keys=["k"], build_keys=["k"],
        probe=P.TableScan("l"), build=P.TableScan("r"),
        output_capacity=64,
    )
    _run(plan, tables)


def test_right_outer_empty_probe():
    tables = _tables()
    plan = P.Join(
        kind="right_outer", probe_keys=["k"], build_keys=["k"],
        probe=P.Selection(
            cond=__import__("tiflash_jax.expr.nodes", fromlist=["Call"]).Call(
                "greater", (
                    __import__("tiflash_jax.expr.nodes",
                               fromlist=["ColumnRef"]).ColumnRef("lv"),
                    __import__("tiflash_jax.expr.nodes",
                               fromlist=["Literal"]).Literal(10 ** 9),
                )
            ),
            child=P.TableScan("l"),
        ),
        build=P.TableScan("r"),
        output_capacity=64,
    )
    got = _run(plan, tables)
    # every live build row appears exactly once, all probe cols NULL
    assert sorted(v for v in got["rv"]) == [200, 300, 301, 400, 600, 700]
    assert all(v is None for v in got["lv"])


def test_distributed_shuffle_right_outer():
    import jax
    import numpy as _np
    from jax.sharding import Mesh

    from tiflash_jax.mpp.runner import (
        collect_result, compile_distributed, shard_catalog_blocks,
    )
    from tiflash_jax.plan.distribute import shuffle_join

    tables = _tables()
    mesh = Mesh(_np.array(jax.devices()), ("d",))
    plan = shuffle_join(
        "right_outer", ["k"], ["k"],
        P.TableScan("l"), P.TableScan("r"), output_capacity=64,
    )
    fn = compile_distributed(plan, mesh)
    out, ov = fn(shard_catalog_blocks(tables, mesh))
    for k, v in ov.items():
        assert not bool(np.any(np.asarray(v))), (k, v)
    got = collect_result(out).to_pylists()
    single = P.Join(
        kind="right_outer", probe_keys=["k"], build_keys=["k"],
        probe=P.TableScan("l"), build=P.TableScan("r"), output_capacity=64,
    )
    sout, _ = compile_fragment(single)(tables)
    want = sout.to_pylists()

    def norm(t):
        ks = sorted(t)
        return sorted(
            tuple(repr(x) for x in row) for row in zip(*[t[k] for k in ks])
        )

    assert norm(got) == norm(want)
