"""The exact CIE94 kernels' divide, `csrc/delta_e.cuh::div_by_recip`, on the CPU.

The tiled CIE94 loops of `csrc/quantize_assign.cu` and
`csrc/lloyd_accumulate.cu` divide by a pixel's S_C and S_H^2 through their
hoisted reciprocals: y = RN(1 / d), q0 = RN(x y), nr = RN(d q0 - x) (one
FMA, exact), q = RN(q0 - nr y) (one FMA). Markstein's theorem makes q the
correctly rounded x / d when nothing underflows or overflows; the kernels
take it for d in [1, 2^32] and x zero or 2^-64 <= |x| <= 2^64, and redo a
pixel with the IEEE divide otherwise. These tests run that sequence in
exact rational arithmetic (each operation rounded to float32, ties to
even) on the kernels' own operands and on the guard's edges, and hold it
to numpy's float32 division bit for bit. No card and no JAX.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

F32_MAX = Fraction(int(np.finfo(np.float32).max))
TINY = np.float32(2.0**-64)
HUGE = np.float32(2.0**64)
# `kTinyDividend` in csrc/delta_e.cuh: the bits of 2^-64, less one.
K_TINY_DIVIDEND = 0x1F800000 - 1


def bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def rn32(v: Fraction, sign_if_zero: int = 1) -> np.float32:
    """`v` rounded to the nearest float32, ties to even (subnormals and
    overflow included)."""
    if v == 0:
        return np.float32(0.0 if sign_if_zero > 0 else -0.0)
    sign, a = (1, v) if v > 0 else (-1, -v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    if Fraction(2) ** (e + 1) <= a:
        e += 1
    q = max(e, -126) - 23  # the exponent of one ulp at `a`
    m = a / Fraction(2) ** q
    n = m.numerator // m.denominator
    rem = m - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2 == 1):
        n += 1
    val = n * Fraction(2) ** q
    if val > F32_MAX:
        return np.float32(sign * np.inf)
    return np.float32(sign * float(val))


def _signbit(x) -> int:
    return -1 if np.signbit(np.float32(x)) else 1


def mul(a, b) -> np.float32:
    return rn32(Fraction(float(a)) * Fraction(float(b)), _signbit(a) * _signbit(b))


def fma(a, b, c) -> np.float32:
    """RN(a b + c), one rounding; an exact zero takes IEEE's sign rule."""
    p = Fraction(float(a)) * Fraction(float(b))
    sp = _signbit(a) * _signbit(b)
    zero_sign = sp if (p == 0 and float(c) == 0 and sp == _signbit(c)) else 1
    return rn32(p + Fraction(float(c)), zero_sign)


def rcp(d) -> np.float32:
    return rn32(1 / Fraction(float(d)))


def div_by_recip(x, d, y) -> np.float32:
    """`csrc/delta_e.cuh::div_by_recip`, operation for operation."""
    q0 = mul(x, y)
    nr = fma(d, q0, -np.float32(x))
    return fma(-nr, y, q0)


def guarded_div(x, d) -> np.float32:
    """The kernels' divide as a whole: the hoisted-reciprocal quotient where
    its guard holds, else the IEEE divide (`__fdiv_rn`)."""
    x, d = np.float32(x), np.float32(d)
    in_range = np.isfinite(x) and (x == 0 or TINY <= abs(x) <= HUGE)
    if 1 <= d <= 2.0**32 and in_range:
        return div_by_recip(x, d, rcp(d))
    with np.errstate(all="ignore"):
        return x / d


def same_bits(a, b) -> bool:
    a, b = np.float32(a), np.float32(b)
    return (np.isnan(a) and np.isnan(b)) or bits(a) == bits(b)


def cie94_operands(n_pixels: int, k: int, seed: int):
    """(dcab, dhab_sq, sc, sh2) of every pixel-centroid pair of seeded sRGB
    pixels against a seeded palette, in float32 in `cie94_sq`'s order."""
    rng = np.random.default_rng(seed)
    pix = srgb8_to_lab(torch.from_numpy(rng.integers(0, 256, (n_pixels, 3), dtype=np.uint8)))
    pal = srgb8_to_lab(torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)))
    pix, pal = pix.numpy().astype(np.float32), pal.numpy().astype(np.float32)
    f32 = np.float32

    def chroma(a, b):
        return np.sqrt(a * a + b * b, dtype=np.float32)

    c1 = chroma(pix[:, 1], pix[:, 2])[:, None]
    c2 = chroma(pal[:, 1], pal[:, 2])[None, :]
    da = pix[:, 1:2] - pal[None, :, 1]
    db = pix[:, 2:3] - pal[None, :, 2]
    dcab = c1 - c2
    hsq = (da * da + db * db) - dcab * dcab
    dhab_sq = np.maximum(hsq, f32(0))
    sc = f32(1) + f32(0.045) * c1
    sh = f32(1) + f32(0.015) * c1
    sh2 = sh * sh
    shape = dcab.shape
    return (dcab.reshape(-1), dhab_sq.reshape(-1), np.broadcast_to(sc, shape).reshape(-1),
            np.broadcast_to(sh2, shape).reshape(-1))


def test_exact_on_the_kernels_operands():
    """About 2,000 pixel-centroid pairs (two divides each) from seeded
    images and palettes: the hoisted-reciprocal quotients equal numpy's
    float32 division bit for bit, none needs the guard, and the whole CIE94
    distance equals the one taken with true divides."""
    dcab, dhab, sc, sh2 = cie94_operands(125, 16, seed=7)
    assert dcab.size == 2000
    guarded = 0
    for x, d in zip(np.concatenate([dcab, dhab]), np.concatenate([sc, sh2])):
        assert 1 <= d <= 2.0**32
        if not (x == 0 or TINY <= abs(x) <= HUGE):
            guarded += 1
        got = div_by_recip(x, d, rcp(d))
        assert same_bits(got, x / d), (x, d, got, x / d)
    assert guarded == 0
    for i in range(0, dcab.size, 97):
        t_true, t_recip = dcab[i] / sc[i], div_by_recip(dcab[i], sc[i], rcp(sc[i]))
        h_true, h_recip = dhab[i] / sh2[i], div_by_recip(dhab[i], sh2[i], rcp(sh2[i]))
        assert same_bits(t_true * t_true + h_true, t_recip * t_recip + h_recip)


EDGE_X = [
    0.0, -0.0, 2.0**-64, -(2.0**-64),
    float(np.nextafter(np.float32(2.0**-64), np.float32(0))),  # just below the guard
    1e-40, -1e-40,  # subnormal
    float(np.finfo(np.float32).tiny), 2.0**64, -(2.0**64),
    float(np.nextafter(np.float32(2.0**64), np.float32(np.inf))),
    float(np.finfo(np.float32).max), np.inf, -np.inf, np.nan, 1.0, -3.5, 123.456,
]
EDGE_D = [1.0, float(np.nextafter(np.float32(1), np.float32(2))), 1.5, 9.0625, 7.0,
          2.0**32, 3.0, 0.5, np.inf, np.nan]


@pytest.mark.parametrize("d", EDGE_D)
def test_guarded_divide_equals_ieee_at_the_edges(d):
    """The guard's edges (zero of either sign, 2^-64 and the float below it,
    subnormal, huge, infinite and NaN dividends; divisors at and outside
    [1, 2^32]): the guarded divide equals numpy's float32 division, signed
    zeros included."""
    for x in EDGE_X:
        with np.errstate(all="ignore"):
            want = np.float32(x) / np.float32(d)
        assert same_bits(guarded_div(x, d), want), (x, d)


def test_the_guard_bounds_and_the_tiny_dividend_check():
    """Every in-range quotient the guard admits at its edges is exact, and
    `kTinyDividend`'s unsigned check flags exactly the nonzero |x| below
    2^-64 (a zero wraps to the largest value)."""
    for d in (1.0, 1.5, 9.0625, 2.0**32):
        for x in (2.0**-64, -(2.0**-64), 2.0**64, 1.0, 0.0, -0.0):
            y = rcp(d)
            assert same_bits(div_by_recip(x, d, y), np.float32(x) / np.float32(d)), (x, d)
    assert bits(2.0**-64) - 1 == K_TINY_DIVIDEND
    for x in EDGE_X:
        flagged = (bits(abs(np.float32(x))) - 1) % 2**32 < K_TINY_DIVIDEND
        expected = bool(np.float32(x) != 0 and abs(np.float32(x)) < TINY)
        assert flagged == expected, x


def test_the_operand_range_bounds_every_dividend():
    """The range a tile's pixels and centroids are held to
    (`Cie94Pixel::ok`, `cie94_centroid_ok`: S_C and S_H^2 in [1, 2^32],
    |a| and |b| up to 2^30) keeps every dividend finite and at most 2^64,
    so the loop checks only for small ones."""
    f32 = np.float32
    big = f32(2.0**30)
    c1_max = f32((2.0**16 - 1) / 0.015)  # S_H^2 just under 2^32
    sh = f32(1) + f32(0.015) * c1_max
    assert sh * sh <= 2.0**32
    for pa, pb, ca, cb in ((big, big, -big, -big), (-big, big, big, -big), (big, 0, -big, 0)):
        c2 = np.sqrt(f32(ca) * f32(ca) + f32(cb) * f32(cb), dtype=np.float32)
        for c1 in (f32(0), c1_max):
            da, db, dcab = f32(pa) - f32(ca), f32(pb) - f32(cb), c1 - c2
            hsq = (da * da + db * db) - dcab * dcab
            dhab_sq = max(hsq, f32(0))
            for x in (dcab, dhab_sq):
                assert np.isfinite(x) and abs(x) <= 2.0**64


WHITE_POINT = {"X": (95.0489, (0.4124564, 0.3575761, 0.1804375)),
               "Y": (100.0, (0.2126729, 0.7151522, 0.0721750)),
               "Z": (108.8840, (0.0193339, 0.1191920, 0.9503041))}


def _header_reciprocals() -> dict:
    import re
    from pathlib import Path

    import kmeans_tpu_torch

    text = (Path(kmeans_tpu_torch.__file__).parent / "csrc" / "colorspace.cuh").read_text()
    return {m.group(1): float.fromhex(m.group(2))
            for m in re.finditer(r"constexpr float kRcpWp([XYZ]) = (0x[0-9a-f.]+p-?\d+)f;", text)}


def test_white_point_reciprocals_and_quotients():
    """The image kernels divide the XYZ sums by the white point through
    `colorspace.cuh`'s hex reciprocals: each is RN(1 / F32(wp)),
    and on every sum a gamma-table pixel gives (each channel alone, and
    2,000 seeded triples, in the kernel's order) the quotient equals numpy's
    float32 division, each sum 0 or inside the guard's range."""
    from kmeans_tpu_torch.ops.gamma_lut import gamma_lut_np

    f32 = np.float32
    recips = _header_reciprocals()
    assert set(recips) == {"X", "Y", "Z"}
    lut = gamma_lut_np()
    rng = np.random.default_rng(11)
    triples = np.concatenate([
        np.stack([np.arange(256), np.zeros(256, int), np.zeros(256, int)], -1),
        np.stack([np.zeros(256, int), np.arange(256), np.zeros(256, int)], -1),
        np.stack([np.zeros(256, int), np.zeros(256, int), np.arange(256)], -1),
        rng.integers(0, 256, (2000, 3)),
    ])
    for axis, (wp, rows) in WHITE_POINT.items():
        d, y = f32(wp), f32(recips[axis])
        assert same_bits(y, rcp(d))
        m0, m1, m2 = (f32(v) for v in rows)
        r, g, b = lut[triples[:, 0]], lut[triples[:, 1]], lut[triples[:, 2]]
        sums = (m0 * r + m1 * g) + m2 * b
        for s in np.unique(sums):
            assert s == 0 or TINY <= s <= HUGE
            assert same_bits(div_by_recip(s, d, y), s / d), (axis, s)
