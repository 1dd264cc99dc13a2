"""The numpy reference inside ``chip_smoke.py`` against the plan oracle.

``chip_smoke.py`` checks the engine's answers on the card against a plain
numpy reference that shares no code with the engine.  These tests hold
that reference, and the checks that compare with it, to the independent
python plan oracle (``testing/plan_oracle.py``) at TPC-H SF0.001.
"""

import datetime
import decimal

import numpy as np
import pytest

import chip_smoke
from tiflash_jax.storage.tpch import generate_tpch
from tiflash_jax.testing import oracle as O
from tiflash_jax.testing.plan_oracle import execute_plan_oracle

# decimal scale of each result column (the engine's result types)
SCALES = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4,
          "sum_charge": 6, "avg_qty": 6, "avg_price": 6, "avg_disc": 6,
          "revenue": 4, "l_extendedprice": 2}


@pytest.fixture(scope="module")
def tpch():
    cat = generate_tpch(sf=0.001, seed=3, tables=chip_smoke.TPCH_TABLES)
    host, dicts = chip_smoke.host_tables(cat)
    pytables = {n: O.block_to_pytable(b) for n, b in cat.blocks().items()}
    return host, dicts, pytables


def _as_mantissas(table):
    """Oracle values in the engine's ``to_pylists`` form: decimals as
    integer mantissas, dates as days since 1970-01-01."""
    out = {}
    for name, vals in table.items():
        conv = []
        for v in vals:
            if isinstance(v, decimal.Decimal):
                m = v.scaleb(SCALES[name])
                assert m == m.to_integral_value(), (name, v)
                v = int(m)
            elif isinstance(v, datetime.date):
                v = (v - datetime.date(1970, 1, 1)).days
            conv.append(v)
        out[name] = conv
    return out


@pytest.mark.parametrize("query", ["q1", "q6", "q3", "top100"])
def test_reference_matches_plan_oracle(query, tpch):
    host, dicts, pytables = tpch
    plan = chip_smoke.query_plans()[query]()
    oracle = _as_mantissas(execute_plan_oracle(plan, pytables))
    ref_fn, check = chip_smoke.REFERENCES[query]
    check(oracle, ref_fn(host, dicts))


def test_reference_check_rejects_a_wrong_answer(tpch):
    host, dicts, pytables = tpch
    plan = chip_smoke.query_plans()["q1"]()
    oracle = _as_mantissas(execute_plan_oracle(plan, pytables))
    oracle["sum_charge"][0] += 1
    with pytest.raises(AssertionError):
        chip_smoke.check_exact(oracle, chip_smoke.ref_q1(host, dicts))


def test_exact_sum_past_int64():
    x = np.full(1 << 12, (1 << 62) - 3, dtype=np.int64)
    x[::2] = -(1 << 61)
    assert chip_smoke.exact_sum(x) == sum(int(v) for v in x)
    assert chip_smoke.exact_sum(x) > (1 << 63)


def test_refuses_to_run_without_a_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU found" in out.err
