"""Regression tests for the round-1 advisor findings (ADVICE.md).

1. (high) string-keyed shuffle joins must hash string VALUES, not
   dictionary codes — different encodings on the two sides otherwise send
   equal keys to different devices and silently lose matches.
2. (medium) probe strings absent from the build dictionary are real values
   with no match, NOT NULL — null-aware kinds must keep/flag them.
3. (medium) string literals on the generic call path (if/coalesce/
   case_when) must land in a harmonized dictionary space and results must
   carry a dictionary.
4. (low) a false ``unique_build`` promise must not silently drop matches —
   the runner retries on the duplicate-correct general path.
5. (low) a corrupt/truncated TFC cache must be rejected, not crash.
"""

import numpy as np
import pytest
from jax.sharding import Mesh

import jax
import tiflash_jax.core.dtypes as dt
from tiflash_jax.core.block import Block, column_from_numpy
from tiflash_jax.expr.nodes import Call, col, lit
from tiflash_jax.expr.compile import evaluate_expr
from tiflash_jax.mpp.runner import (
    ExchangeConfig,
    collect_result,
    compile_distributed,
    shard_catalog_blocks,
)
from tiflash_jax.ops import join as J
from tiflash_jax.plan import nodes as P
from tiflash_jax.plan.distribute import shuffle_join
from tiflash_jax.testing import oracle as O


def _string_block(name, values, extra=None):
    schema = {name: dt.STRING}
    tbl = {name: list(values)}
    if extra:
        for k, v in extra.items():
            schema[k] = dt.INT64
            tbl[k] = list(v)
    return tbl, O.pytable_to_block(tbl, schema)


# ---------------------------------------------------------------------------
# 1. value-based hashing for string shuffle keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8
    return Mesh(devs, ("d",))


def test_shuffle_join_string_keys_cross_dictionary(mesh):
    # left/right dictionaries overlap but differ, so the same string gets
    # DIFFERENT codes on the two sides; code-based hashing lost matches.
    rng = np.random.default_rng(7)
    shared = [f"key{i:02d}" for i in range(12)]
    lvals = rng.choice(shared + ["lonly1", "lonly2"], size=96).tolist()
    rvals = rng.choice(shared + ["ronly1"], size=64).tolist()
    lt = {"lk": lvals, "lv": list(range(96))}
    rt = {"rk": rvals, "rv": list(range(64))}
    lb = O.pytable_to_block(lt, {"lk": dt.STRING, "lv": dt.INT64})
    rb = O.pytable_to_block(rt, {"rk": dt.STRING, "rv": dt.INT64})
    assert lb["lk"].dictionary != rb["rk"].dictionary
    blocks = shard_catalog_blocks({"l": lb, "r": rb}, mesh)
    plan = shuffle_join(
        "inner", ["lk"], ["rk"], P.TableScan("l"), P.TableScan("r"),
        output_capacity=4096,
    )
    fn = compile_distributed(plan, mesh, cfg=ExchangeConfig(shuffle_factor=8.0))
    out, overflows = fn(blocks)
    for k, v in overflows.items():
        assert not bool(np.asarray(v).max()), f"overflow at {k}"
    got = O.block_to_pytable(collect_result(out))
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_string_hash_is_dictionary_independent():
    from tiflash_jax.ops.hashing import hash_columns

    a = column_from_numpy(["apple", "pear", "plum"], dt.STRING)
    b = column_from_numpy(["apple", "zebra", "pear", "plum", "kiwi"], dt.STRING)
    ha = np.asarray(hash_columns([a]))
    hb = np.asarray(hash_columns([b]))
    assert ha[0] == hb[0]  # "apple"
    assert ha[1] == hb[2]  # "pear"
    assert ha[2] == hb[3]  # "plum"


# ---------------------------------------------------------------------------
# 2. dictionary-absent probe keys are NOT NULL
# ---------------------------------------------------------------------------


def test_not_in_keeps_absent_string():
    # 'x' NOT IN ('a','b') is TRUE — the row must be kept even though 'x'
    # is absent from the build dictionary.
    _, lb = _string_block("lk", ["x", "a", "y"])
    _, rb = _string_block("rk", ["a", "b"])
    joined, _ = J.hash_join(lb, rb, ["lk"], ["rk"], kind="anti_null_aware")
    got = O.block_to_pytable(joined)
    assert sorted(got["lk"]) == ["x", "y"]


def test_in_select_list_absent_string_is_false_not_null():
    # 'x' IN ('a','b') is FALSE (not NULL) when neither side has NULLs.
    _, lb = _string_block("lk", ["x", "a"])
    _, rb = _string_block("rk", ["a", "b"])
    joined, _ = J.hash_join(
        lb, rb, ["lk"], ["rk"], kind="left_outer_semi_null_aware"
    )
    got = O.block_to_pytable(joined)
    by_key = dict(zip(got["lk"], got["__semi_matched"]))
    assert by_key["x"] is False
    assert by_key["a"] is True


def test_absent_string_still_null_when_actually_null():
    lt = {"lk": ["x", None, "a"]}
    lb = O.pytable_to_block(lt, {"lk": dt.STRING.with_nullable(True)})
    _, rb = _string_block("rk", ["a", "b"])
    joined, _ = J.hash_join(lb, rb, ["lk"], ["rk"], kind="anti_null_aware")
    got = O.block_to_pytable(joined)
    # NULL NOT IN (non-empty) is NULL -> dropped; 'x' kept; 'a' matched
    assert got["lk"] == ["x"]


# ---------------------------------------------------------------------------
# 3. string literals / dictionaries on the generic call path
# ---------------------------------------------------------------------------


def _eval(expr, block):
    return evaluate_expr(expr, block)


def test_coalesce_string_literal():
    lt = {"s": ["apple", None, "pear", None]}
    b = O.pytable_to_block(lt, {"s": dt.STRING.with_nullable(True)})
    out = _eval(Call("coalesce", (col("s"), lit("banana"))), b)
    assert out.dictionary is not None
    assert out.to_pylist() == ["apple", "banana", "pear", "banana"]


def test_if_with_string_literal_then_column():
    lt = {"c": [1, 0, 1], "s": ["x", "y", "z"]}
    b = O.pytable_to_block(lt, {"c": dt.BOOL, "s": dt.STRING})
    out = _eval(Call("if", (col("c"), lit("lit"), col("s"))), b)
    assert out.to_pylist() == ["lit", "y", "lit"]


def test_case_when_mixing_two_dictionaries():
    lt = {"c": [1, 0, 0], "a": ["aa", "bb", "cc"], "z": ["zz", "yy", "xx"]}
    b = O.pytable_to_block(
        lt, {"c": dt.BOOL, "a": dt.STRING, "z": dt.STRING}
    )
    out = _eval(Call("case_when", (col("c"), col("a"), col("z"))), b)
    assert out.to_pylist() == ["aa", "yy", "xx"]


def test_equals_across_dictionaries():
    lt = {"a": ["p", "q", "r"], "b": ["p", "x", "r"]}
    b = O.pytable_to_block(lt, {"a": dt.STRING, "b": dt.STRING})
    out = _eval(Call("equals", (col("a"), col("b"))), b)
    assert out.to_pylist() == [True, False, True]


def test_order_compare_across_dictionaries():
    lt = {"a": ["apple", "pear"], "b": ["banana", "fig"]}
    b = O.pytable_to_block(lt, {"a": dt.STRING, "b": dt.STRING})
    out = _eval(Call("less", (col("a"), col("b"))), b)
    assert out.to_pylist() == [True, False]


# ---------------------------------------------------------------------------
# 4. false unique_build promise fails loudly (and self-heals via retry)
# ---------------------------------------------------------------------------


def test_false_unique_build_retries_to_correct_result():
    from tiflash_jax.runtime.executor import QueryRunner

    lt = {"lk": [1, 2, 3], "lv": [10, 20, 30]}
    rt = {"rk": [1, 1, 2], "rv": [100, 101, 200]}  # duplicate build key!
    lb = O.pytable_to_block(lt, {"lk": dt.INT64, "lv": dt.INT64})
    rb = O.pytable_to_block(rt, {"rk": dt.INT64, "rv": dt.INT64})
    plan = P.Join(
        probe=P.TableScan("l"), build=P.TableScan("r"),
        probe_keys=("lk",), build_keys=("rk",), kind="inner",
        unique_build=True,  # a LIE
    )
    runner = QueryRunner(plan)
    out, summary = runner.run({"l": lb, "r": rb})
    got = O.block_to_pytable(out)
    want = O.o_join(lt, rt, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)
    assert summary.retries >= 1  # the lie was detected, not silently absorbed


def test_true_unique_build_no_retry():
    from tiflash_jax.runtime.executor import QueryRunner

    lt = {"lk": [1, 2, 3], "lv": [10, 20, 30]}
    rt = {"rk": [1, 2], "rv": [100, 200]}
    lb = O.pytable_to_block(lt, {"lk": dt.INT64, "lv": dt.INT64})
    rb = O.pytable_to_block(rt, {"rk": dt.INT64, "rv": dt.INT64})
    plan = P.Join(
        probe=P.TableScan("l"), build=P.TableScan("r"),
        probe_keys=("lk",), build_keys=("rk",), kind="inner",
        unique_build=True,
    )
    runner = QueryRunner(plan)
    out, summary = runner.run({"l": lb, "r": rb})
    assert summary.retries == 0


# ---------------------------------------------------------------------------
# 5. corrupt TFC cache rejected cleanly
# ---------------------------------------------------------------------------


def test_corrupt_cache_rejected(tmp_path):
    import struct

    from tiflash_jax.storage import native_loader

    try:
        lib = native_loader.get_lib()
    except Exception:
        pytest.skip("native loader not built")

    # absurd ncols (would have bad_alloc'd on blind resize)
    p = tmp_path / "bad.tfc"
    p.write_bytes(struct.pack("<IqI", 0x54464331, 1 << 40, 1 << 30))
    assert not lib.tfl_load_cache(str(p).encode())

    # valid header, truncated column payload (silently zero-filled before)
    p2 = tmp_path / "bad2.tfc"
    p2.write_bytes(
        struct.pack("<IqI", 0x54464331, 4, 1)
        + struct.pack("<iiq", 0, 0, 32)
        + b"\x00" * 8  # only 8 of 32 bytes present
    )
    assert not lib.tfl_load_cache(str(p2).encode())

    # nbytes inconsistent with rows
    p3 = tmp_path / "bad3.tfc"
    p3.write_bytes(
        struct.pack("<IqI", 0x54464331, 4, 1)
        + struct.pack("<iiq", 0, 0, 8)
        + b"\x00" * 8  # 1 row's worth of bytes, header says 4 rows
    )
    assert not lib.tfl_load_cache(str(p3).encode())

    # round trip of a GOOD table still works
    from tiflash_jax.core.block import column_from_numpy

    good = tmp_path / "good.tfc"
    cols = {"a": column_from_numpy([1, 2, 3], dt.INT64)}
    native_loader.save_table(str(good), cols)
    back = native_loader.load_cached_table(str(good), [("a", dt.INT64)])
    assert np.asarray(back["a"].data).tolist() == [1, 2, 3]


def test_operator_threshold_is_operator_local():
    """ADVICE r2: a tiny sort above a large scan must not trip
    max_bytes_before_external_sort — the threshold compares against the
    sort's OWN working set (its input after selections + transients),
    not the whole plan's."""
    import numpy as np

    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.core.block import Block, column_from_numpy
    from tiflash_jax.expr.nodes import col, lit
    from tiflash_jax.ops.sort import SortKey
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.memory import (estimate_operator_bytes,
                                            estimate_plan_bytes)

    n = 100_000
    blk = Block.from_dict({
        "a": column_from_numpy(np.arange(n) % 97, dt.INT64),
        "b": column_from_numpy(np.arange(n), dt.INT64),
    })
    tables = {"T": blk}
    # selection keeps ~1% of rows; the sort sees a tiny input
    plan = P.TopN([SortKey("b")], 5,
                  P.Selection(col("a") < lit(1), P.TableScan("T")))
    whole = estimate_plan_bytes(plan, tables)
    sort_ws = estimate_operator_bytes(plan, tables, (P.TopN, P.Sort))
    # the whole plan is big (inputs dominate); the sort's working set is
    # bounded by its input (the selection output model keeps full width,
    # so it is <= the scan) — assert strict separation
    assert sort_ws < whole
    assert sort_ws > 0


def test_mesh_threshold_notice_logged():
    """ADVICE r2: thresholds under a mesh log a one-time notice instead
    of being silently ignored."""
    import numpy as np

    import jax
    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.core.block import Block, column_from_numpy
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.logging import RING
    from tiflash_jax.runtime.settings import Settings

    devs = jax.devices()
    mesh = jax.sharding.Mesh(np.array(devs), ("d",))
    n = 1024
    blk = Block.from_dict({
        "g": column_from_numpy(np.arange(n) % 4, dt.INT64),
        "v": column_from_numpy(np.arange(n), dt.INT64),
    })
    plan = P.Aggregation(["g"], [AggDesc("sum", "v", "s")], P.TableScan("T"))
    s = Settings(max_bytes_before_external_group_by=1)
    from tiflash_jax.runtime.executor import run_query

    out, _ = run_query(plan, {"T": blk}, mesh=mesh, settings=s)
    assert int(np.asarray(out.sel_mask()).sum()) == 4
    hits = RING.search("single-chip runs only")
    assert hits, "expected a one-time notice about mesh-ignored thresholds"
