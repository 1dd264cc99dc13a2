"""CLI smoke tests (DTTool/debug-client analog surface)."""

import io
import json

import numpy as np

import tiflash_jax.core.dtypes as dt
from tiflash_jax.cli import _repl, main
from tiflash_jax.storage.catalog import Catalog
from tiflash_jax.testing import oracle as O


def _catalog():
    schema = {"k": dt.INT64, "v": dt.INT64}
    table = O.random_pytable(np.random.default_rng(1), 50, schema, null_prob=0)
    cat = Catalog()
    b = O.pytable_to_block(table, schema)
    cat.register("t", dict(zip(b.names, b.columns)))
    return cat, table


PLAN = {"exec": "Aggregation", "keys": ["k"],
        "aggs": [{"func": "sum", "arg": "v", "name": "s",
                  "filter_col": None, "param": None}],
        "num_slots": None, "mode": None,
        "child": {"exec": "TableScan", "table": "t", "columns": None}}


def test_repl_session():
    cat, table = _catalog()
    cmds = "\n".join([
        "tables",
        "explain " + json.dumps(PLAN),
        json.dumps(PLAN),
        "summary",
        "not json at all",
        "quit",
    ]) + "\n"
    out = io.StringIO()
    rc = _repl(cat, None, limit=100, inp=io.StringIO(cmds), outp=out)
    assert rc == 0
    text = out.getvalue()
    assert "t  rows=50" in text
    assert "Aggregation" in text          # explain output
    assert "k\ts" in text                  # result header
    assert "TableScan" in text             # summary plan text
    assert "error:" in text                # bad input reported, loop survived
    want = O.o_aggregate(table, ["k"], [("sum", "v", "s")])
    first_k, first_s = want["k"][0], want["s"][0]
    assert f"{first_k}\t{first_s}" in text


def test_cli_tables_and_metrics(capsys):
    main(["--tpch-sf", "0.001", "--tables", "region", "tables"])
    out = capsys.readouterr().out
    assert "region" in out and "rows=5" in out
    main(["metrics"])
    assert "{" in capsys.readouterr().out
