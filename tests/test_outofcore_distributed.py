"""Config-5 composition (VERDICT r2 item 3): out-of-core grace
partitioning COMPOSED with distributed execution — each grace partition
runs hash-shuffle exchanges across the 8-device mesh.  Reference
discipline: multi-node MPP + spill without a cluster
(Flash/tests/gtest_compute_server.cpp)."""

import numpy as np
import pytest

import jax
import tiflash_jax.core.dtypes as dt
from tiflash_jax.ops.aggregate import AggDesc
from tiflash_jax.ops.sort import SortKey
from tiflash_jax.plan import nodes as P
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.runtime.settings import Settings
from tiflash_jax.testing import oracle as O


@pytest.fixture(scope="module")
def mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]), ("d",))


def _norm(block):
    return O.sort_pytable(O.block_to_pytable(block.compact()))


def test_grace_join_distributed_composition(mesh, tmp_path):
    """Q3-shape (join + high-cardinality group-by + topN) forced
    out-of-core UNDER A MESH: grace partitions x 8-device shuffle."""
    rng = np.random.default_rng(41)
    n, m = 40_000, 4_000
    lt = {"fk": [int(x) for x in rng.integers(0, m, n)],
          "v": [int(x) for x in rng.integers(0, 100, n)]}
    rt = {"pk": list(range(m)),
          "w": [int(x) for x in rng.integers(0, 50, m)]}
    lsch = {"fk": dt.INT64, "v": dt.INT64}
    rsch = {"pk": dt.INT64, "w": dt.INT64}
    tables = {"L": O.pytable_to_block(lt, lsch),
              "R": O.pytable_to_block(rt, rsch)}
    plan = P.TopN(
        [SortKey("s", desc=True), SortKey("fk")], 10,
        P.Aggregation(
            ["fk"], [AggDesc("sum", "w", "s"), AggDesc("count", None, "c")],
            P.Join(kind="inner", probe_keys=["fk"], build_keys=["pk"],
                   probe=P.TableScan("L"), build=P.TableScan("R"),
                   unique_build=True)))

    ref, _ = run_query(plan, tables)  # single-chip in-RAM reference

    s = Settings(max_bytes_per_device=200_000, spill_dir=str(tmp_path))
    got, summary = run_query(plan, tables, mesh=mesh, settings=s)
    assert "grace out-of-core" in summary.plan_text
    assert summary.num_devices == 8
    O.assert_tables_equal(_norm(got), _norm(ref), ordered=True)


def test_grace_outer_join_distributed(mesh, tmp_path):
    """Right-outer (build tail crosses partitions) composed with the
    mesh: matched-flag OR must hold per grace partition."""
    rng = np.random.default_rng(43)
    n, m = 20_000, 3_000
    lt = {"fk": [int(x) for x in rng.integers(0, 2 * m, n)],
          "v": [int(x) for x in rng.integers(0, 9, n)]}
    rt = {"pk": list(range(m)), "w": [int(x) for x in rng.integers(0, 9, m)]}
    tables = {"L": O.pytable_to_block(lt, {"fk": dt.INT64, "v": dt.INT64}),
              "R": O.pytable_to_block(rt, {"pk": dt.INT64, "w": dt.INT64})}
    plan = P.Aggregation(
        ["pk"], [AggDesc("count", None, "c"), AggDesc("sum", "v", "sv")],
        P.Join(kind="right_outer", probe_keys=["fk"], build_keys=["pk"],
               probe=P.TableScan("L"), build=P.TableScan("R"),
               output_capacity=1 << 16))

    ref, _ = run_query(plan, tables)
    s = Settings(max_bytes_per_device=120_000, spill_dir=str(tmp_path))
    got, summary = run_query(plan, tables, mesh=mesh, settings=s)
    assert "grace out-of-core" in summary.plan_text
    O.assert_tables_equal(_norm(got), _norm(ref), ordered=True)
