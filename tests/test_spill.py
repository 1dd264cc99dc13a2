"""Native disk spill tier (Core/Spiller.h analog): compressed chunk
roundtrip, corruption detection, and spill-backed out-of-core execution
vs the in-RAM path."""

import numpy as np
import pytest


def test_spiller_roundtrip_all_dtypes(tmp_path):
    from tiflash_jax.runtime.spill import Spiller

    rng = np.random.default_rng(0)
    arrays = [
        rng.integers(-2**60, 2**60, 10_000).astype(np.int64),
        rng.integers(0, 2**30, 3_333).astype(np.int32),
        rng.normal(size=5_000).astype(np.float64),
        (rng.random(7_000) < 0.5),
        rng.integers(0, 100, (500, 8)).astype(np.int32),  # 2-D (group_concat)
        np.zeros(0, dtype=np.int64),                      # empty
    ]
    with Spiller(str(tmp_path / "s")) as sp:
        ids = [sp.spill_array(a, partition=i % 3) for i, a in enumerate(arrays)]
        sp.sync()
        raw, comp = sp.stats()
        assert raw == sum(a.nbytes for a in arrays)
        assert 0 < comp  # compressed something
        for a, cid in zip(arrays, ids):
            got = sp.restore_array(cid)
            assert got.dtype == a.dtype and got.shape == a.shape
            np.testing.assert_array_equal(got, a)


def test_spiller_detects_corruption(tmp_path):
    import glob

    from tiflash_jax.runtime.spill import Spiller

    sp = Spiller(str(tmp_path / "c"))
    a = np.arange(50_000, dtype=np.int64)
    cid = sp.spill_array(a)
    sp.sync()
    path = glob.glob(str(tmp_path / "c" / "*.spl"))[0]
    blob = bytearray(open(path, "rb").read())
    blob[40] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        sp.restore_array(cid)
    sp.close()


def test_spiller_removes_files_on_close(tmp_path):
    import glob

    from tiflash_jax.runtime.spill import Spiller

    d = str(tmp_path / "rm")
    sp = Spiller(d)
    sp.spill_array(np.arange(1000))
    sp.sync()
    assert glob.glob(d + "/*.spl")
    sp.close(remove_files=True)
    assert not glob.glob(d + "/*.spl")


def _grace_setup():
    import tiflash_jax.core.dtypes as dt
    from tiflash_jax.expr.nodes import col
    from tiflash_jax.ops.aggregate import AggDesc
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.testing import oracle as O

    rng = np.random.default_rng(17)
    n, m = 6000, 900
    lsch = {"fk": dt.INT64, "v": dt.INT64}
    rsch = {"pk": dt.INT64, "w": dt.INT64.with_nullable(True)}
    lt = O.random_pytable(rng, n, lsch, null_prob=0.0, int_range=(0, m - 1))
    rt = {"pk": list(range(m)),
          "w": [None if rng.random() < 0.1 else int(rng.integers(0, 50))
                for _ in range(m)]}
    plan = P.TopN(
        [__import__("tiflash_jax.ops.sort", fromlist=["SortKey"]).SortKey("s", desc=True),
         __import__("tiflash_jax.ops.sort", fromlist=["SortKey"]).SortKey("fk")],
        7,
        P.Aggregation(
            ["fk"], [AggDesc("sum", "w", "s")],
            P.Join(kind="inner", probe_keys=["fk"], build_keys=["pk"],
                   probe=P.TableScan("L"), build=P.TableScan("R"),
                   unique_build=True),
        ),
    )
    tables = {"L": O.pytable_to_block(lt, lsch), "R": O.pytable_to_block(rt, rsch)}
    return plan, tables, (lt, rt)


def test_grace_join_with_disk_spill_matches_in_ram(tmp_path):
    from tiflash_jax.runtime.outofcore import run_grace_join
    from tiflash_jax.testing import oracle as O

    plan, tables, _ = _grace_setup()
    budget = 400_000  # force several partitions
    in_ram = run_grace_join(plan, tables, budget)
    on_disk = run_grace_join(plan, tables, budget,
                             spill_dir=str(tmp_path / "spl"))
    a = O.sort_pytable(O.block_to_pytable(in_ram.compact()))
    b = O.sort_pytable(O.block_to_pytable(on_disk.compact()))
    O.assert_tables_equal(a, b, ordered=True)


def test_runner_spill_dir_setting(tmp_path):
    """QueryRunner routes out-of-core staging through spill_dir."""
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.settings import Settings
    from tiflash_jax.testing import oracle as O

    plan, tables, _ = _grace_setup()
    s = Settings(max_bytes_per_device=400_000,
                 spill_dir=str(tmp_path / "q"))
    out, summary = QueryRunner(plan, settings=s).run(tables)
    assert "out-of-core" in summary.plan_text
    got = O.block_to_pytable(out.compact())
    s2 = Settings()  # plenty of memory: normal path as reference
    ref, _ = QueryRunner(plan, settings=s2).run(tables)
    want = O.block_to_pytable(ref.compact())
    O.assert_tables_equal(O.sort_pytable(got), O.sort_pytable(want), ordered=True)


def test_per_operator_external_join_threshold():
    """max_bytes_before_external_join (Settings.h:321) forces the grace
    path even when the global device quota is satisfied."""
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.settings import Settings
    from tiflash_jax.testing import oracle as O

    plan, tables, _ = _grace_setup()
    # no global quota; the threshold compares against the JOIN's own
    # working set (~253KB here), not the whole plan (ADVICE r2 fix)
    s = Settings(max_bytes_before_external_join=200_000)
    out, summary = QueryRunner(plan, settings=s).run(tables)
    assert "grace out-of-core" in summary.plan_text
    ref, _ = QueryRunner(plan, settings=Settings()).run(tables)
    O.assert_tables_equal(
        O.sort_pytable(O.block_to_pytable(out.compact())),
        O.sort_pytable(O.block_to_pytable(ref.compact())), ordered=True)


def test_per_operator_external_group_by_threshold():
    import numpy as np

    from tiflash_jax.core import dtypes as dt
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.settings import Settings
    from tiflash_jax.testing import oracle as O

    rng = np.random.default_rng(7)
    n = 60_000
    from tiflash_jax.testing import oracle as O2
    sch = {"g": dt.INT64, "v": dt.INT64}
    pt = O2.random_pytable(rng, n, sch, null_prob=0.0, int_range=(-100, 100))
    pt["g"] = [abs(x) % 8 for x in pt["g"]]
    tables = {"t": O2.pytable_to_block(pt, sch)}
    plan = P.Aggregation(["g"], [P.AggDesc("sum", "v", "s"),
                                 P.AggDesc("count", None, "c")],
                         P.TableScan("t"))
    s = Settings(max_bytes_before_external_group_by=200_000)
    out, summary = QueryRunner(plan, settings=s).run(tables)
    assert "chunked out-of-core" in summary.plan_text
    ref, _ = QueryRunner(plan, settings=Settings()).run(tables)
    O.assert_tables_equal(
        O.sort_pytable(O.block_to_pytable(out.compact())),
        O.sort_pytable(O.block_to_pytable(ref.compact())), ordered=True)


def test_bucketed_final_merge_parity(monkeypatch):
    """Force the MergingBuckets-analog final merge (group-key-hash
    buckets, one reused small final program) and check parity with the
    in-memory result — the SF10 high-cardinality rehearsal path."""
    import numpy as np

    from tiflash_jax.core import dtypes as dt
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime import outofcore
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.settings import Settings
    from tiflash_jax.testing import oracle as O

    rng = np.random.default_rng(11)
    n = 60_000
    sch = {"g": dt.INT64, "v": dt.INT64}
    pt = O.random_pytable(rng, n, sch, null_prob=0.0,
                          int_range=(-1000, 1000))
    # high-cardinality groups relative to n: many survive per chunk
    pt["g"] = [abs(x) % 4096 for x in pt["g"]]
    tables = {"t": O.pytable_to_block(pt, sch)}
    plan = P.Aggregation(["g"], [P.AggDesc("sum", "v", "s"),
                                 P.AggDesc("count", None, "c"),
                                 P.AggDesc("avg", "v", "a"),
                                 P.AggDesc("min", "v", "lo")],
                         P.TableScan("t"))
    # tiny bucket capacity -> several buckets; tiny threshold -> path on
    monkeypatch.setattr(outofcore, "_FINAL_MERGE_ROWS", 2048)
    s = Settings(max_bytes_before_external_group_by=200_000)
    out, summary = QueryRunner(plan, settings=s).run(tables)
    assert "chunked out-of-core" in summary.plan_text
    ref, _ = QueryRunner(plan, settings=Settings()).run(tables)
    O.assert_tables_equal(
        O.sort_pytable(O.block_to_pytable(out.compact())),
        O.sort_pytable(O.block_to_pytable(ref.compact())), ordered=True)


def test_final_merge_compile_failure_ladder(monkeypatch):
    """Arm the compile-failure failpoint so BOTH device rungs of the
    bucketed-final-merge fallback ladder fail, landing in the host-side
    numpy merge — and check exact parity with the in-memory result
    (the engineering-around-the-SIGSEGV path, VERDICT r4 item 1)."""
    import numpy as np

    from tiflash_jax.core import dtypes as dt
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.runtime import outofcore
    from tiflash_jax.runtime.executor import QueryRunner
    from tiflash_jax.runtime.failpoint import FailPoint
    from tiflash_jax.runtime.settings import Settings
    from tiflash_jax.testing import oracle as O

    rng = np.random.default_rng(13)
    n = 60_000
    sch = {"g": dt.INT64, "v": dt.INT64, "d": dt.Decimal(15, 2),
           "f": dt.FLOAT64}
    pt = O.random_pytable(rng, n, sch, null_prob=0.1,
                          int_range=(-1000, 1000))
    pt["g"] = [1 if x is None else abs(x) % 4096 for x in pt["g"]]
    tables = {"t": O.pytable_to_block(pt, sch)}
    plan = P.Aggregation(
        ["g"],
        [P.AggDesc("sum", "v", "s"),
         P.AggDesc("count", None, "c"),
         P.AggDesc("avg", "v", "a"),       # post-projection re-applied
         P.AggDesc("min", "v", "lo"),
         P.AggDesc("max", "f", "hi"),
         P.AggDesc("sum", "d", "ds"),      # narrow-stored wide typing
         P.AggDesc("first", "v", "fv")],
        P.TableScan("t"))
    monkeypatch.setattr(outofcore, "_FINAL_MERGE_ROWS", 2048)
    FailPoint.enable("compile_failure_in_final_merge")
    try:
        s = Settings(max_bytes_before_external_group_by=200_000)
        out, summary = QueryRunner(plan, settings=s).run(tables)
    finally:
        FailPoint.disable("compile_failure_in_final_merge")
    assert "chunked out-of-core" in summary.plan_text
    assert FailPoint.get("compile_failure_in_final_merge").hits == 2
    ref, _ = QueryRunner(plan, settings=Settings()).run(tables)
    O.assert_tables_equal(
        O.sort_pytable(O.block_to_pytable(out.compact())),
        O.sort_pytable(O.block_to_pytable(ref.compact())), ordered=True)
