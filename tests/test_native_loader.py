"""Native C++ loader tests: TBL parse, typed columns, dictionary
encoding, binary cache round-trip (the IO/DMFile-reader tier)."""

import os

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.storage.native_loader import load_table

TBL = """1|alpha|12.34|1995-03-15|7.5
2|beta|0.5|2001-12-31|-3.25
3|alpha|-99.99|1970-01-01|0
4||1234.567|1999-02-28|1e3
"""

SCHEMA = [
    ("id", dt.INT64),
    ("name", dt.STRING),
    ("amount", dt.Decimal(12, 2)),
    ("day", dt.DATE),
    ("x", dt.FLOAT64),
]


@pytest.fixture()
def tbl_file(tmp_path):
    p = tmp_path / "t.tbl"
    p.write_text(TBL)
    return str(p)


def test_parse_types(tbl_file):
    cols = load_table(tbl_file, SCHEMA)
    assert np.asarray(cols["id"].data).tolist() == [1, 2, 3, 4]
    # decimal scale-2: 12.34 -> 1234; 1234.567 truncates to 1234.56
    assert np.asarray(cols["amount"].data).tolist() == [1234, 50, -9999, 123456]
    import datetime

    days = np.asarray(cols["day"].data).tolist()
    assert days[0] == (datetime.date(1995, 3, 15) - datetime.date(1970, 1, 1)).days
    assert days[2] == 0
    assert np.asarray(cols["x"].data).tolist() == [7.5, -3.25, 0.0, 1000.0]


def test_string_dictionary_sorted(tbl_file):
    cols = load_table(tbl_file, SCHEMA)
    c = cols["name"]
    assert c.dictionary == ("", "alpha", "beta")  # sorted distinct
    assert np.asarray(c.data).tolist() == [1, 2, 1, 0]


def test_skip_column(tbl_file):
    schema = [("id", dt.INT64), ("name", None), ("amount", None),
              ("day", None), ("x", None)]
    cols = load_table(tbl_file, schema)
    assert list(cols) == ["id"]


def test_cache_roundtrip(tbl_file, tmp_path):
    cache = str(tmp_path / "t.tfc")
    a = load_table(tbl_file, SCHEMA, cache=cache)
    assert os.path.exists(cache)
    # poison the source to prove the cache is used
    open(tbl_file, "w").write("999|zzz|1|2020-01-01|0\n")
    b = load_table(tbl_file, SCHEMA, cache=cache)
    for k in a:
        assert np.asarray(a[k].data).tolist() == np.asarray(b[k].data).tolist()
        assert a[k].dictionary == b[k].dictionary


def test_multithreaded_parse_matches(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    lines = []
    for i in range(n):
        lines.append(f"{i}|s{int(rng.integers(0, 50))}|{rng.integers(0, 10**6)/100:.2f}|1995-01-01|{rng.normal():.4f}")
    p = tmp_path / "big.tbl"
    p.write_text("\n".join(lines) + "\n")
    one = load_table(str(p), SCHEMA, nthreads=1)
    four = load_table(str(p), SCHEMA, nthreads=4)
    for k in one:
        assert np.asarray(one[k].data).tolist() == np.asarray(four[k].data).tolist()


def test_save_and_reload_engine_columns(tmp_path):
    """Engine block -> TFC file -> reload: exact round-trip incl. strings."""
    from tiflash_jax.storage.native_loader import load_cached_table, save_table
    from tiflash_jax.testing import oracle as O

    schema = {"k": dt.STRING, "v": dt.Decimal(12, 2), "d": dt.DATE,
              "x": dt.FLOAT64, "i": dt.INT64}
    t = {
        "k": ["b", "a", "b", "c"],
        "v": [O.D("1.25"), O.D("-3.00"), O.D("0.10"), O.D("99.99")],
        "d": [__import__("datetime").date(2020, 1, i + 1) for i in range(4)],
        "x": [0.5, -1.5, 2.0, 3.25],
        "i": [10, -20, 30, -40],
    }
    block = O.pytable_to_block(t, schema)
    path = str(tmp_path / "out.tfc")
    names = save_table(path, dict(zip(block.names, block.columns)))
    cols = load_cached_table(path, [(n, schema[n]) for n in names])
    reloaded = O.block_to_pytable(
        __import__("tiflash_jax").Block.from_dict(cols)
    )
    O.assert_tables_equal(reloaded, t, ordered=True)


def test_catalog_append_write_path():
    """INSERT analog: appended rows visible to queries; merged dictionaries."""
    from tiflash_jax.storage.catalog import Catalog
    from tiflash_jax.testing import oracle as O
    from tiflash_jax.plan import nodes as P
    from tiflash_jax.plan.compiler import compile_fragment
    from tiflash_jax.ops.aggregate import AggDesc

    schema = {"k": dt.STRING, "v": dt.INT64}
    cat = Catalog()
    b1 = O.pytable_to_block({"k": ["b", "a"], "v": [1, 2]}, schema)
    cat.register("t", dict(zip(b1.names, b1.columns)))
    b2 = O.pytable_to_block({"k": ["c", "a"], "v": [3, 4]}, schema)
    cat.append("t", dict(zip(b2.names, b2.columns)))
    assert cat["t"].row_count == 4
    plan = P.Aggregation(["k"], [AggDesc("sum", "v", "s")], P.TableScan("t"))
    out, _ = compile_fragment(plan)(cat.blocks())
    got = O.block_to_pytable(out)
    want = {"k": ["a", "b", "c"], "s": [6, 1, 3]}
    O.assert_tables_equal(got, want)
