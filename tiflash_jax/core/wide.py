"""Multi-limb wide-decimal arithmetic (precision 19..65).

Role analog: the reference's ``Decimal128``/``Decimal256`` mantissas
(``/root/reference/dbms/src/DataTypes/DataTypeDecimal.h:194``,
``Common/Decimal.h``) — re-designed for XLA: no int128/int256 type
exists there, so a wide mantissa is L int64 limbs in base 10^18,

    value = limb[0] * (10**18)**(L-1) + ... + limb[L-1],
    limb[0] signed, limbs[1..L-1] in [0, 10**18)

stored as a trailing-dim-L array ``(..., L)`` (the same 2-D column layout
the group_concat matrix already rides through take/concat/shuffle).
L = 2 covers precision <= 38 exactly below ~9.2e36 (36 full digits);
L = 4 is the Decimal256 analog covering precision <= 65 (the top limb
carries 64+ bits of headroom, so 65 digits are always exact).

All limb-generic functions here key off ``w.shape[-1]``; the historical
two-limb names (``widen_i64``/``make_wide``/...) remain the L=2 fast
path used by the aggregation kernels.  All internal arithmetic
decomposes limbs into base-10^9 digits so every intermediate
product/sum fits int64 — no float detours, bit-exact.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax.numpy as jnp

W9 = 10 ** 9
W18 = 10 ** 18
MAX_WIDE_PRECISION = 65


def wide_hi(w: jnp.ndarray) -> jnp.ndarray:
    return w[..., 0]


def wide_lo(w: jnp.ndarray) -> jnp.ndarray:
    return w[..., 1]


def make_wide(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([hi.astype(jnp.int64), lo.astype(jnp.int64)], axis=-1)


def widen_i64(x: jnp.ndarray) -> jnp.ndarray:
    """int64 mantissa -> two-limb.  jnp floor-div keeps lo in [0, W18)."""
    hi = x // W18
    return make_wide(hi, x - hi * W18)


def narrow_i64(w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """two-limb -> (int64 value, fits_flag).  Value is garbage where the
    flag is False (|value| >= 2**63).  The product wraps (two's
    complement) but is exact whenever the flag is True."""
    hi, lo = wide_hi(w), wide_lo(w)
    val = hi * W18 + lo
    max_lo_at_9 = 2 ** 63 - 1 - 9 * W18    # hi == 9 ceiling
    min_lo_at_m10 = 10 * W18 - 2 ** 63     # hi == -10 floor
    fits = ((hi < 9) | ((hi == 9) & (lo <= max_lo_at_9))) & (
        (hi > -10) | ((hi == -10) & (lo >= min_lo_at_m10))
    )
    return val, fits


def digits_of_wide(w: jnp.ndarray) -> List[jnp.ndarray]:
    """Base-10^9 digit decomposition [d0, d1, ..., d_{2L-1}] (d0 least
    significant, top digit signed) for any limb count L = w.shape[-1]."""
    L = w.shape[-1]
    out: List[jnp.ndarray] = []
    for i in range(L - 1, -1, -1):
        limb = w[..., i]
        hi9 = limb // W9
        out.append(limb - hi9 * W9)
        out.append(hi9)
    return out


def digits_of_i64(x: jnp.ndarray) -> List[jnp.ndarray]:
    """int64 -> [d0, d1] base-10^9 digits (d0 in [0, W9), d1 signed)."""
    d1 = x // W9
    return [x - d1 * W9, d1]


# largest t with |out2 + t*W9| < 2^63 for any out2 in [0, W9)
_MAX_TOP = (2 ** 63 - 1 - (W9 - 1)) // W9


def renorm_digits(digits: Sequence[jnp.ndarray],
                  limbs: int = 2) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Carry-normalize base-10^9 digit values (each |digit| <= ~2^62/10 —
    all in-repo callers sum at most ~1e9 bounded digits) into an
    ``limbs``-limb value + overflow flag (value outside the representable
    range for that limb count).

    Returns (wide (..., limbs), overflowed bool (...))."""
    nd = 2 * limbs
    ds = list(digits) + [jnp.zeros_like(digits[0])] * (nd - len(digits))
    if len(ds) > nd:
        raise ValueError(f"{len(ds)} digits exceed {limbs} limbs")
    out = []
    carry = jnp.zeros_like(ds[0])
    for i in range(nd):
        cur = ds[i] + carry
        carry = cur // W9          # floor: out digits stay in [0, W9)
        out.append(cur - carry * W9)
    # top limb = out[nd-2] + top*W9 with top = out[nd-1] + carry*W9 —
    # representable only while |top| <= _MAX_TOP
    top = out[nd - 1] + carry * W9
    overflow = jnp.abs(top) > _MAX_TOP
    top = jnp.clip(top, -_MAX_TOP, _MAX_TOP)
    top_limb = out[nd - 2] + top * W9
    lower = [out[2 * j] + out[2 * j + 1] * W9
             for j in range(limbs - 2, -1, -1)]  # MSB-first below top
    arr = jnp.stack([top_limb.astype(jnp.int64)]
                    + [x.astype(jnp.int64) for x in lower], axis=-1)
    return arr, overflow


def wide_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    L = a.shape[-1]
    out = [None] * L
    carry = 0
    for i in range(L - 1, 0, -1):
        cur = a[..., i] + b[..., i] + carry
        carry = cur // W18
        out[i] = cur - carry * W18
    out[0] = a[..., 0] + b[..., 0] + carry
    return jnp.stack([x.astype(jnp.int64) for x in out], axis=-1)


def wide_neg(a: jnp.ndarray) -> jnp.ndarray:
    L = a.shape[-1]
    out = [None] * L
    borrow = 0
    for i in range(L - 1, 0, -1):
        t = a[..., i] + borrow
        nz = t > 0
        out[i] = jnp.where(nz, W18 - t, 0)
        borrow = nz.astype(jnp.int64)
    out[0] = -(a[..., 0] + borrow)
    return jnp.stack([x.astype(jnp.int64) for x in out], axis=-1)


def wide_mul_pow10(w: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """value * 10**k exactly (0 <= k <= 9).  Returns (wide, overflow)."""
    assert 0 <= k <= 9
    if k == 0:
        return w, jnp.zeros(w.shape[:-1], dtype=jnp.bool_)
    m = 10 ** k
    digits = [d * m for d in digits_of_wide(w)]  # each < 1e9*1e9 = 1e18
    return renorm_digits(digits, limbs=w.shape[-1])


def wide_mul_pow2(w: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """value * 2**k exactly (k >= 0).  Returns (wide, overflow).  Steps of
    2^20 keep every scaled base-10^9 digit below renorm's ~4.6e17 input
    bound for ANY representable wide (|d3| <= 9.3e9)."""
    ov = jnp.zeros(w.shape[:-1], dtype=jnp.bool_)
    while k > 0:
        m = min(k, 20)
        digits = [d * jnp.int64(1 << m) for d in digits_of_wide(w)]
        w, o = renorm_digits(digits, limbs=w.shape[-1])
        ov = ov | o
        k -= m
    return w, ov


def wide_cmp_lt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a < b lexicographically on limbs — valid because limbs below the
    top are in [0, W18)."""
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    L = a.shape[-1]
    lt = a[..., L - 1] < b[..., L - 1]
    for i in range(L - 2, -1, -1):
        lt = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & lt)
    return lt


def wide_eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    eq = a[..., 0] == b[..., 0]
    for i in range(1, a.shape[-1]):
        eq = eq & (a[..., i] == b[..., i])
    return eq


def wide_div_round_half_up(w: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """value / c with TiDB ROUND_HALF_UP (away from zero), c positive
    int64 <= ~9e9 (row counts).  Base-10^9 long division."""
    L = w.shape[-1]
    neg = w[..., 0] < 0
    mag = jnp.where(neg[..., None], wide_neg(w), w)
    ds = digits_of_wide(mag)         # LSB first
    c = c.astype(jnp.int64)
    q = []
    rem = jnp.zeros_like(ds[0])
    for d in reversed(ds):           # most-significant first
        cur = rem * W9 + d           # rem < c <= 9.2e9 -> cur < 9.2e18: ok
        qi = cur // c
        rem = cur - qi * c
        q.append(qi)
    # half-up on the remainder; q is MSB-first -> reverse to LSB-first
    q = q[::-1]
    q[0] = q[0] + (rem * 2 >= c).astype(jnp.int64)
    out, _ = renorm_digits(q, limbs=L)
    return jnp.where(neg[..., None], wide_neg(out), out)


def wide_sub(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return wide_add(a, wide_neg(b))


def wide_to_f64(w: jnp.ndarray) -> jnp.ndarray:
    """float64 value (relative error a few ulp).  Negatives are negated
    to MAGNITUDE limbs before combining: the floor layout stores -1.1e20
    as [-1, 999.., 999.., 0], and combining that directly cancels
    catastrophically (-1e54 + ~1e54 leaves absolute error ~1e38)."""
    neg = w[..., 0] < 0
    mag = jnp.where(neg[..., None], wide_neg(w), w)
    acc = mag[..., 0].astype(jnp.float64)
    for i in range(1, w.shape[-1]):
        acc = acc * float(W18) + mag[..., i].astype(jnp.float64)
    return jnp.where(neg, -acc, acc)


def _div_small_floor(w: jnp.ndarray, c) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """floor(w / c) and remainder for NON-NEGATIVE w and small positive
    int c <= ~9.2e9 (so rem * W9 + digit fits int64)."""
    c = jnp.asarray(c, dtype=jnp.int64)
    ds = digits_of_wide(w)            # LSB first
    q = []
    rem = jnp.zeros_like(ds[0])
    for d in reversed(ds):            # MSB first
        cur = rem * W9 + d
        qi = cur // c
        rem = cur - qi * c
        q.append(qi)
    out, _ = renorm_digits(q[::-1], limbs=w.shape[-1])
    return out, rem


# exact-division envelope: values below this renormalize without
# saturation at every internal step (the representable ceiling for L
# limbs is ~9.22e18 * 10^(18*(L-1)))
_DIV_FIT = 9.15e36
_DIV_CAP = 9.18e36


def _div_envelopes(limbs: int):
    ceil = 9.22 * 10 ** (18 * limbs)
    return ceil * 0.992, ceil * 0.995


def _shifted_scaled(
    dd: Sequence[jnp.ndarray], k: int, c: Optional[jnp.ndarray],
    limbs: int = 2,
) -> jnp.ndarray:
    """den * c * W9**k as an ``limbs``-limb value (c=None means c==1),
    assuming the caller guarantees the product fits the representable
    range.  Digits landing at positions >= 2*limbs-1 fold into the top
    base-10^9 coefficient (renorm_digits accepts a large signed top
    digit)."""
    zero = jnp.zeros_like(dd[0])
    ntop = 2 * limbs - 1
    pos = [zero] * ntop
    top = zero
    for j, d in enumerate(dd):
        p = j + k
        if p < ntop:
            pos[p] = d
        else:
            f = W9 ** (p - ntop)
            if f < 2 ** 62:  # higher folds require d == 0 to fit anyway
                top = top + d * f
    if c is not None:
        pos = [x * c for x in pos]
        top = top * c
    w, _ = renorm_digits(pos + [top], limbs=limbs)
    return w


def wide_divmod(w: jnp.ndarray, den: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """floor(|w| / |den|) and remainder, sign applied to the quotient
    (truncating division); ``den`` must be nonzero.  Exact for
    |w| <= 9.0e36 (i.e. anything up to 36 full decimal digits).

    Restoring base-10^9 long division over quotient digit positions
    W9^4..W9^0.  Each digit is SEEDED from a float64 ratio (relative
    error ~2^-52, so off by at most ~2 given the previous step was
    exact) and CORRECTED with exact two-limb arithmetic — two
    conditional restore steps in each direction.  Every intermediate
    product is capped (``_DIV_CAP``) below the representable ceiling so
    renormalization never saturates.  Role analog: Int256 decimal
    division (``Common/Decimal.h`` DivDecimalInferer consumers) — no
    int128/256 type exists in XLA, so division decomposes into digit
    estimates that int64 arithmetic can verify exactly."""
    L = w.shape[-1]
    if den.shape[-1] != L:  # mixed limb counts: re-limb the divisor
        den, _ = resize_wide(den, L)
    fit_f, cap_f = _div_envelopes(L)
    neg = (w[..., 0] < 0) ^ (den[..., 0] < 0)
    r = jnp.where((w[..., 0] < 0)[..., None], wide_neg(w), w)
    dmag = jnp.where((den[..., 0] < 0)[..., None], wide_neg(den), den)
    dd = digits_of_wide(dmag)
    denf = wide_to_f64(dmag)
    nq = 2 * L           # quotient digit positions W9^0 .. W9^(2L-1)
    qdigits: List[jnp.ndarray] = []
    for k in range(nq, -1, -1):
        denkf = denf * float(W9) ** k
        fits = denkf < fit_f
        if k == 0:
            fits = fits | jnp.ones_like(fits)  # den itself always fits
        denk = _shifted_scaled(dd, k, None, limbs=L)
        # cap keeps c*denk below the saturation ceiling while never
        # capping below the true digit (floor(CAP/denk)*denk >= CAP-denk)
        cap = jnp.floor(cap_f / denkf)
        est = jnp.floor(wide_to_f64(r) / denkf)
        c = jnp.minimum(jnp.clip(est, 0.0, float(W9 + 2)), cap).astype(jnp.int64)
        c = jnp.where(fits, c, 0)
        r = wide_sub(r, _shifted_scaled(dd, k, c, limbs=L))
        for _ in range(2):  # float undershoot: r still >= den*W9^k
            over = fits & ~wide_cmp_lt(r, denk) & (r[..., 0] >= 0)
            c = c + over.astype(jnp.int64)
            r = jnp.where(over[..., None], wide_sub(r, denk), r)
        for _ in range(2):  # float overshoot: r went negative
            under = fits & (r[..., 0] < 0)
            c = c - under.astype(jnp.int64)
            r = jnp.where(under[..., None], wide_add(r, denk), r)
        qdigits.append(c)
    qdigits = qdigits[::-1]          # now LSB first, length nq+1
    qdigits[nq - 1] = qdigits[nq - 1] + qdigits[nq] * W9
    q, _ = renorm_digits(qdigits[:nq], limbs=L)
    q = jnp.where(neg[..., None], wide_neg(q), q)
    return q, r


def wide_div_wide_round_half_up(w: jnp.ndarray, den: jnp.ndarray) -> jnp.ndarray:
    """w / den with TiDB ROUND_HALF_UP (away from zero), den nonzero wide."""
    if den.shape[-1] != w.shape[-1]:
        den, _ = resize_wide(den, w.shape[-1])
    q, r = wide_divmod(w, den)
    dmag = jnp.where((den[..., 0] < 0)[..., None], wide_neg(den), den)
    # bump iff 2r >= |den|  <=>  r >= ceil(|den| / 2); 2r itself may exceed
    # the representable range, so compare against the halved divisor
    half_ceil, _ = _div_small_floor(
        wide_add(dmag, widen_i64_to(jnp.ones_like(den[..., 0]),
                                    den.shape[-1])), 2)
    bump = ~wide_cmp_lt(r, half_ceil)
    neg = (w[..., 0] < 0) ^ (den[..., 0] < 0)
    one = widen_i64_to(jnp.ones_like(w[..., 0]), w.shape[-1])
    q = jnp.where(
        bump[..., None],
        jnp.where(neg[..., None], wide_sub(q, one), wide_add(q, one)),
        q,
    )
    return q


def wide_mul(a: jnp.ndarray, b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """a * b exactly, with an overflow flag for |product| beyond ~9.05e36.

    Base-10^9 schoolbook product on magnitudes; digit positions >= 3 fold
    into the (large, signed-tolerant) top renorm digit.  Per-term wraps
    can only occur for products the float overflow check already flags."""
    L = max(a.shape[-1], b.shape[-1])
    if a.shape[-1] != L:
        a, _ = resize_wide(a, L)
    if b.shape[-1] != L:
        b, _ = resize_wide(b, L)
    neg = (a[..., 0] < 0) ^ (b[..., 0] < 0)
    ma = jnp.where((a[..., 0] < 0)[..., None], wide_neg(a), a)
    mb = jnp.where((b[..., 0] < 0)[..., None], wide_neg(b), b)
    da, db = digits_of_wide(ma), digits_of_wide(mb)
    zero = jnp.zeros_like(da[0])
    ntop = 2 * L - 1
    pos = [zero] * ntop
    top = zero
    for i in range(2 * L):
        for j in range(2 * L):
            p = i + j
            if p < ntop:
                pos[p] = pos[p] + da[i] * db[j]
            else:
                f = W9 ** (p - ntop)
                if f < 2 ** 62:
                    top = top + da[i] * db[j] * f
    w, ovf = renorm_digits(pos + [top], limbs=L)
    ovf = ovf | (wide_to_f64(ma) * wide_to_f64(mb)
                 > 0.98 * 9.22 * 10 ** (18 * L))
    return jnp.where(neg[..., None], wide_neg(w), w), ovf


def wide_scale_up(w: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """value * 10**k for any k >= 0 (chunked through wide_mul_pow10)."""
    ovf = jnp.zeros(w.shape[:-1], dtype=jnp.bool_)
    while k > 0:
        w, o = wide_mul_pow10(w, min(k, 9))
        ovf = ovf | o
        k -= 9
    return w, ovf


def wide_sum_digits(
    digit_cols: Sequence[jnp.ndarray],
    reduce_fn: Callable[[jnp.ndarray], jnp.ndarray],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Overflow-free wide summation: reduce each base-10^9 digit column
    independently with ``reduce_fn`` (any int64-exact segmented/total sum),
    then carry-normalize.  Exact for up to ~9e9 rows per digit."""
    sums = [reduce_fn(d) for d in digit_cols]
    return renorm_digits(sums)


def wide_to_host_ints(arr, validity=None) -> List:
    """(n, L) host array -> python bigint mantissas (None where invalid)."""
    import numpy as np

    a = np.asarray(arr)
    L = a.shape[-1]
    out = []
    for i in range(a.shape[0]):
        if validity is not None and not validity[i]:
            out.append(None)
        else:
            v = 0
            for j in range(L):
                v = v * W18 + int(a[i, j])
            out.append(v)
    return out


def resize_wide(w: jnp.ndarray, limbs: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Re-limb a wide value to ``limbs`` limbs; (result, overflow flag
    when shrinking loses magnitude).  Canonicalization rides the renorm
    carry chain, so negative values re-limb correctly.  Shrinking keeps
    the low limbs and folds the sign fill (upper limbs all 0, or -1
    followed by 10^18-1 fills) into the new top limb; anything else
    overflows (e.g. a 4-limb division result narrowing to a
    Decimal(38,_) type)."""
    if w.shape[-1] == limbs:
        return w, jnp.zeros(w.shape[:-1], dtype=jnp.bool_)
    if w.shape[-1] < limbs:
        return renorm_digits(digits_of_wide(w), limbs=limbs)
    canon, ov = renorm_digits(digits_of_wide(w), limbs=w.shape[-1])
    cut = w.shape[-1] - limbs
    upper, low = canon[..., :cut], canon[..., cut:]
    pos_fit = jnp.all(upper == 0, axis=-1)
    neg_fit = upper[..., 0] == -1
    for j in range(1, cut):
        neg_fit = neg_fit & (upper[..., j] == W18 - 1)
    new_top = jnp.where(neg_fit, low[..., 0] - W18, low[..., 0])
    out = low.at[..., 0].set(new_top)
    return out, ov | ~(pos_fit | neg_fit)


def widen_i64_to(x: jnp.ndarray, limbs: int) -> jnp.ndarray:
    """int64 mantissa -> L-limb wide."""
    out, _ = renorm_digits(digits_of_i64(x), limbs=limbs)
    return out


__all__ = [
    "W9", "W18", "MAX_WIDE_PRECISION",
    "make_wide", "wide_hi", "wide_lo", "widen_i64", "narrow_i64",
    "digits_of_wide", "digits_of_i64", "renorm_digits",
    "wide_add", "wide_neg", "wide_mul_pow10", "wide_mul_pow2",
    "wide_cmp_lt", "wide_eq", "wide_div_round_half_up",
    "wide_sum_digits", "wide_to_host_ints", "resize_wide", "widen_i64_to",
]
