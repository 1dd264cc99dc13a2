"""core/wide.py two-limb decimal arithmetic vs python bigints."""

import numpy as np
import jax.numpy as jnp

from tiflash_jax.core import wide as W


def _rand_values(rng, n, mag):
    exp = rng.integers(0, mag, size=n)
    v = (rng.integers(1, 10, size=n).astype(object)) * (10 ** exp.astype(object))
    jitter = np.array([int(rng.integers(-10 ** 6, 10 ** 6)) for _ in range(n)],
                      dtype=object)
    sign = rng.choice([-1, 1], size=n).astype(object)
    return [int(s * (x + abs(j))) for s, x, j in zip(sign, v, jitter)]


def _to_wide(vals):
    hi = jnp.asarray([v // W.W18 for v in vals], dtype=jnp.int64)
    lo = jnp.asarray([v % W.W18 for v in vals], dtype=jnp.int64)
    return W.make_wide(hi, lo)


def _to_ints(w):
    return W.wide_to_host_ints(np.asarray(w))


def test_widen_narrow_roundtrip():
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, size=200)]
    w = W.widen_i64(jnp.asarray(vals, dtype=jnp.int64))
    assert _to_ints(w) == vals
    back, fits = W.narrow_i64(w)
    assert np.asarray(fits).all()
    assert np.asarray(back).tolist() == vals


def test_add_neg_cmp():
    rng = np.random.default_rng(1)
    a = _rand_values(rng, 300, 34)
    b = _rand_values(rng, 300, 34)
    wa, wb = _to_wide(a), _to_wide(b)
    assert _to_ints(W.wide_add(wa, wb)) == [x + y for x, y in zip(a, b)]
    assert _to_ints(W.wide_neg(wa)) == [-x for x in a]
    assert np.asarray(W.wide_cmp_lt(wa, wb)).tolist() == [
        x < y for x, y in zip(a, b)
    ]
    assert np.asarray(W.wide_eq(wa, wa)).all()


def test_renorm_digit_sums():
    rng = np.random.default_rng(2)
    n, k = 64, 1000
    # k bounded digit rows summed per output slot; the top digit stays
    # small enough that the total fits the representable ~9.2e36 range
    d = rng.integers(0, W.W9, size=(4, k, n))
    d[3] = rng.integers(0, 10 ** 6, size=(k, n))
    sums = [jnp.asarray(d[i].sum(axis=0), dtype=jnp.int64) for i in range(4)]
    w, ovf = W.renorm_digits(sums)
    assert not np.asarray(ovf).any()
    expect = [
        int(d[0, :, j].sum()) + int(d[1, :, j].sum()) * W.W9
        + int(d[2, :, j].sum()) * W.W9 ** 2 + int(d[3, :, j].sum()) * W.W9 ** 3
        for j in range(n)
    ]
    assert _to_ints(w) == expect


def test_renorm_overflow_flag():
    big = jnp.asarray([2 ** 62], dtype=jnp.int64)
    zero = jnp.zeros(1, dtype=jnp.int64)
    _, ovf = W.renorm_digits([zero, zero, zero, big])
    assert bool(np.asarray(ovf)[0])


def test_mul_pow10():
    rng = np.random.default_rng(3)
    vals = _rand_values(rng, 200, 27)
    w = _to_wide(vals)
    for k in (0, 1, 4, 9):
        out, ovf = W.wide_mul_pow10(w, k)
        assert not np.asarray(ovf).any()
        assert _to_ints(out) == [v * 10 ** k for v in vals]


def test_div_round_half_up():
    rng = np.random.default_rng(4)
    vals = _rand_values(rng, 400, 34)
    cnts = [int(c) for c in rng.integers(1, 4 * 10 ** 9, size=400)]
    w = _to_wide(vals)
    c = jnp.asarray(cnts, dtype=jnp.int64)
    got = _to_ints(W.wide_div_round_half_up(w, c))

    def py_half_up(v, c):
        q, r = divmod(abs(v), c)
        q += 1 if 2 * r >= c else 0
        return q if v >= 0 else -q

    assert got == [py_half_up(v, c) for v, c in zip(vals, cnts)]


def test_sum_digits_many_rows():
    rng = np.random.default_rng(5)
    n = 5000
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, size=n)]
    x = jnp.asarray(vals, dtype=jnp.int64)
    w, ovf = W.wide_sum_digits(W.digits_of_i64(x), lambda d: jnp.sum(d))
    assert not bool(np.asarray(ovf))
    assert int(np.asarray(w[0])) * W.W18 + int(np.asarray(w[1])) == sum(vals)
