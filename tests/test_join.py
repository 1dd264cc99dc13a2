"""Hash-join parity tests (engine vs oracle).

Role analog: ``Flash/tests/gtest_join_executor.cpp`` — join kinds ×
key shapes, unique-build fast path and general N:M expansion.
"""

import numpy as np
import pytest

import tiflash_jax.core.dtypes as dt
from tiflash_jax.ops import join as J
from tiflash_jax.testing import oracle as O


def make_tables(seed=0, nl=300, nr=120, key_dt=dt.INT32, unique_build=False,
                null_keys=True, nr_extra_cols=True):
    rng = np.random.default_rng(seed)
    lschema = {"lk": key_dt.with_nullable(null_keys), "lv": dt.INT64}
    rschema = {"rk": key_dt.with_nullable(null_keys), "rv": dt.Decimal(10, 2)}
    left = O.random_pytable(rng, nl, lschema, int_range=(0, 40))
    right = O.random_pytable(rng, nr, rschema, int_range=(0, 40))
    if unique_build:
        seen = set()
        ks, vs = [], []
        for k, v in zip(right["rk"], right["rv"]):
            if k is not None and k not in seen:
                seen.add(k)
                ks.append(k)
                vs.append(v)
        right = {"rk": ks, "rv": vs}
    lb = O.pytable_to_block(left, lschema)
    rb = O.pytable_to_block(
        right, {"rk": rschema["rk"], "rv": rschema["rv"]}
    )
    return left, right, lb, rb


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_join_unique_build(kind):
    left, right, lb, rb = make_tables(seed=1, unique_build=True)
    joined, _ = J.hash_join(lb, rb, ["lk"], ["rk"], kind=kind)
    got = O.block_to_pytable(joined)
    want = O.o_join(left, right, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(got, want)


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_join_general_nm(kind):
    left, right, lb, rb = make_tables(seed=2)
    joined, extras = J.hash_join(lb, rb, ["lk"], ["rk"], kind=kind, output_capacity=4096)
    assert not bool(extras["overflow"])
    got = O.block_to_pytable(joined)
    want = O.o_join(left, right, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(got, want)


def test_join_right_outer_scan():
    left, right, lb, rb = make_tables(seed=3)
    joined, extras = J.hash_join(lb, rb, ["lk"], ["rk"], kind="inner", output_capacity=4096)
    tail = J.scan_non_matched(extras["build"], extras["matched_flags"], lb.names, lb)
    got = O.block_to_pytable(joined)
    tail_py = O.block_to_pytable(tail)
    for k in got:
        got[k] = got[k] + tail_py[k]
    want = O.o_join(left, right, ["lk"], ["rk"], kind="right")
    O.assert_tables_equal(got, want)


def test_join_string_keys_cross_dictionary():
    rng = np.random.default_rng(4)
    lschema = {"lk": dt.STRING.with_nullable(True), "lv": dt.INT64}
    rschema = {"rk": dt.STRING, "rv": dt.INT32}
    left = O.random_pytable(rng, 200, lschema, str_pool=["aa", "bb", "cc", "xx"])
    right = O.random_pytable(rng, 50, rschema, str_pool=["bb", "cc", "dd"])
    lb = O.pytable_to_block(left, lschema)
    rb = O.pytable_to_block(right, rschema)
    joined, extras = J.hash_join(lb, rb, ["lk"], ["rk"], kind="inner", output_capacity=8192)
    assert not bool(extras["overflow"])
    got = O.block_to_pytable(joined)
    want = O.o_join(left, right, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


def test_join_multi_column_key():
    rng = np.random.default_rng(5)
    lschema = {"k1": dt.INT32, "k2": dt.STRING, "lv": dt.INT64}
    rschema = {"j1": dt.INT32, "j2": dt.STRING, "rv": dt.INT64}
    left = O.random_pytable(rng, 150, lschema, int_range=(0, 10), str_pool=["a", "b"])
    right = O.random_pytable(rng, 60, rschema, int_range=(0, 10), str_pool=["a", "b", "c"])
    lb = O.pytable_to_block(left, lschema)
    rb = O.pytable_to_block(right, rschema)
    joined, extras = J.hash_join(
        lb, rb, ["k1", "k2"], ["j1", "j2"], kind="inner", output_capacity=16384
    )
    assert not bool(extras["overflow"])
    got = O.block_to_pytable(joined)
    want = O.o_join(left, right, ["k1", "k2"], ["j1", "j2"], kind="inner")
    O.assert_tables_equal(got, want)


def test_join_overflow_reported():
    left = {"lk": [1] * 50, "lv": list(range(50))}
    right = {"rk": [1] * 50, "rv": list(range(50))}
    lschema = {"lk": dt.INT32, "lv": dt.INT64}
    rschema = {"rk": dt.INT32, "rv": dt.INT64}
    lb = O.pytable_to_block(left, lschema)
    rb = O.pytable_to_block(right, rschema)
    _, extras = J.hash_join(lb, rb, ["lk"], ["rk"], kind="inner", output_capacity=100)
    assert bool(extras["overflow"])  # 2500 matches > 100


def test_join_under_jit():
    import jax

    left, right, lb, rb = make_tables(seed=6, unique_build=True)

    @jax.jit
    def run(l, r):
        joined, _ = J.hash_join(l, r, ["lk"], ["rk"], kind="inner")
        return joined

    got = O.block_to_pytable(run(lb, rb))
    want = O.o_join(left, right, ["lk"], ["rk"], kind="inner")
    O.assert_tables_equal(got, want)


@pytest.mark.parametrize("kind", ["inner", "semi", "anti"])
def test_join_wide_keys_hash_verify(kind):
    """3 x int64 key columns (192 bits) -> hashed keys + verification."""
    rng = np.random.default_rng(21)
    ls = {"a": dt.INT64, "b": dt.INT64, "c": dt.INT64, "lv": dt.INT64}
    rs = {"x": dt.INT64, "y": dt.INT64, "z": dt.INT64, "rv": dt.INT64}
    left = O.random_pytable(rng, 200, ls, null_prob=0, int_range=(0, 6))
    right = O.random_pytable(rng, 80, rs, null_prob=0, int_range=(0, 6))
    lb = O.pytable_to_block(left, ls)
    rb = O.pytable_to_block(right, rs)
    joined, extras = J.hash_join(
        lb, rb, ["a", "b", "c"], ["x", "y", "z"], kind=kind,
        output_capacity=16384,
    )
    assert not int(np.asarray(extras["overflow"]))
    got = O.block_to_pytable(joined)
    want = O.o_join(left, right, ["a", "b", "c"], ["x", "y", "z"], kind=kind)
    O.assert_tables_equal(got, want)


@pytest.mark.parametrize("kind", ["left_outer_semi", "left_outer_semi_null_aware"])
@pytest.mark.parametrize("unique", [True, False])
def test_left_outer_semi(kind, unique):
    left, right, lb, rb = make_tables(seed=31, unique_build=unique)
    cap = None if unique else 4096
    joined, _ = J.hash_join(lb, rb, ["lk"], ["rk"], kind=kind, output_capacity=cap)
    got = O.block_to_pytable(joined)
    want = O.o_join(left, right, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(got, want)


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti",
                                  "anti_null_aware"])
@pytest.mark.parametrize("general", [False, True])
def test_join_key_equal_to_sentinel(kind, general):
    """A REAL key of exactly 2^63-1 (the internal NULL sentinel) must join
    normally and must not be confused with NULL-key rows (VERDICT weak 7:
    positional disambiguation via the num_live prefix, not key value)."""
    big = 2**63 - 1
    left = {"lk": [big, big, 5, None, 7], "lv": [1, 2, 3, 4, 5]}
    right = {"rk": [big, 5, None], "rv": [10, 50, 99]}
    lschema = {"lk": dt.INT64.with_nullable(True), "lv": dt.INT64}
    rschema = {"rk": dt.INT64.with_nullable(True), "rv": dt.INT64}
    lb = O.pytable_to_block(left, lschema)
    rb = O.pytable_to_block(right, rschema)
    cap = 64 if general else None
    joined, extras = J.hash_join(lb, rb, ["lk"], ["rk"], kind=kind,
                                 output_capacity=cap)
    assert not bool(extras["overflow"])
    got = O.block_to_pytable(joined)
    if kind == "anti_null_aware":
        want = O.o_anti_null_aware(left, right, ["lk"], ["rk"])
    else:
        want = O.o_join(left, right, ["lk"], ["rk"], kind=kind)
    O.assert_tables_equal(got, want)
    # build-side uniqueness must see the two _KEY_INF-valued LEFT rows as
    # duplicates when the big value is on the build side
    build = J.build_join(
        lb, *J.normalize_join_keys([lb["lk"]], [lb["lk"]])[2:])
    assert not bool(build.unique)
