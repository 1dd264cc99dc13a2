"""Extended TPC-H-shaped query parity (all remaining TPC-H shapes)
vs the plan oracle, single-chip and auto-distributed."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tiflash_jax.bench import tpch_queries as Q
from tiflash_jax.plan.auto import distribute_plan
from tiflash_jax.plan.compiler import compile_fragment
from tiflash_jax.runtime.executor import run_query
from tiflash_jax.storage.tpch import generate_tpch
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle

PLANS = {
    "q2": Q.q2_plan, "q4": Q.q4_plan, "q5": Q.q5_plan, "q7": Q.q7_plan,
    "q8": Q.q8_plan, "q9": Q.q9_plan, "q10": Q.q10_plan, "q11": Q.q11_plan,
    "q12": Q.q12_plan, "q13": lambda: Q.q13_plan(join_capacity=40000),
    "q14": Q.q14_plan, "q15": Q.q15_plan, "q16": Q.q16_plan,
    "q17": Q.q17_plan, "q18": Q.q18_plan, "q19": Q.q19_plan,
    "q20": Q.q20_plan, "q21": Q.q21_plan, "q22": Q.q22_plan,
}


@pytest.fixture(scope="module")
def env():
    cat = generate_tpch(sf=0.002, seed=11)
    blocks = cat.blocks()
    pytables = {n: O.block_to_pytable(b) for n, b in blocks.items()}
    stats = {n: t.row_count for n, t in cat.tables.items()}
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    return blocks, pytables, stats, mesh


@pytest.mark.parametrize("name", list(PLANS))
def test_single_chip(env, name):
    blocks, pytables, _, _ = env
    plan = PLANS[name]()
    out, ov = compile_fragment(plan)(blocks)
    assert all(int(np.asarray(v)) == 0 for v in ov.values()), (name, ov)
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, pytables)
    approx = {"q14": ["promo_share"], "q8": ["mkt_share"],
              "q7": ["revenue"], "q9": ["sum_profit"]}.get(name, ())
    O.assert_tables_equal(got, want, approx_cols=approx)


@pytest.mark.parametrize("name", ["q4", "q12", "q16", "q22", "q18", "q21"])
def test_distributed(env, name):
    blocks, pytables, stats, mesh = env
    plan = PLANS[name]()
    dist = distribute_plan(plan, stats, 8)
    out, _ = run_query(dist, blocks, mesh=mesh)
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, pytables)
    O.assert_tables_equal(got, want)


@pytest.mark.parametrize("name", list(PLANS))
def test_single_chip_pruned(env, name):
    """Column pruning must not change any query's result."""
    from tiflash_jax.plan.rewrite import prune_columns

    blocks, pytables, _, _ = env
    plan = PLANS[name]()
    pruned = prune_columns(plan)
    out, ov = compile_fragment(pruned)(blocks)
    assert all(int(np.asarray(v)) == 0 for v in ov.values()), (name, ov)
    got = O.block_to_pytable(out)
    want = execute_plan_oracle(plan, pytables)
    approx = {"q14": ["promo_share"], "q8": ["mkt_share"],
              "q7": ["revenue"], "q9": ["sum_profit"]}.get(name, ())
    O.assert_tables_equal(got, want, approx_cols=approx)
