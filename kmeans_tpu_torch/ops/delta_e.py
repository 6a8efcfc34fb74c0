"""CIE94 and CIEDE2000 colour differences in PyTorch.

Port of `kmeans_tpu/ops/delta_e.py`. CIE94 is asymmetric: the S_C and S_H
weights use the chroma of the FIRST argument (the pixel or candidate), as
in every kernel of the reference. CIEDE2000 is Sharma et al.'s
formulation, as the reference implements it (without the WGSL shader's
two bugs that its docstring refuses to reproduce). The functions
broadcast, so `lab1[..., None, :]` against `lab2[k, 3]` gives a `[..., k]`
distance matrix.

`cie2000_sq_planes` is the CIEDE2000 formula over separate L, a, b planes
in the float32 operation order of the reference's XLA form
(`kmeans_tpu/ops/delta_e.py:91`): `atan2`, `sin`, `cos` and `exp` are the
library functions, and every `x ** 7` is `lax.integer_pow`'s
square-and-multiply, `(x * x^2) * x^4` with `x^2 = x * x` and
`x^4 = x^2 * x^2`. The port's CUDA kernels (`csrc/delta_e.cuh`) repeat
that order, and the plain twins of `ops/kernels.py` call this function.
"""

from __future__ import annotations

import math

import torch

from kmeans_tpu_torch.ops._math import div

_K1 = 0.045
_K2 = 0.015

# float32(deg2rad(x)) of the reference, and 25^7.
_DEG360 = math.radians(360.0)
_DEG180 = math.radians(180.0)
_RAD30 = math.radians(30.0)
_RAD6 = math.radians(6.0)
_RAD63 = math.radians(63.0)
_RAD275 = math.radians(275.0)
_RAD25 = math.radians(25.0)
_POW25_7 = 6103515625.0


def distance_cie94_sq(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """Squared CIE94 delta-E; monotone in `distance_cie94`, so an argmin
    over it selects the same entry without the square root."""
    dl = lab1[..., 0] - lab2[..., 0]
    da = lab1[..., 1] - lab2[..., 1]
    db = lab1[..., 2] - lab2[..., 2]
    c1 = torch.sqrt(lab1[..., 1] * lab1[..., 1] + lab1[..., 2] * lab1[..., 2])
    c2 = torch.sqrt(lab2[..., 1] * lab2[..., 1] + lab2[..., 2] * lab2[..., 2])
    dcab = c1 - c2
    dhab_sq = torch.clamp(da * da + db * db - dcab * dcab, min=0.0)
    sc = 1.0 + _K1 * c1
    sh = 1.0 + _K2 * c1
    t = dcab / sc
    return dl * dl + t * t + dhab_sq / (sh * sh)


def distance_cie94(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """CIE94 delta-E between Lab colours (last axis `[L, a, b]`)."""
    return torch.sqrt(distance_cie94_sq(lab1, lab2))


def _pow7(x: torch.Tensor) -> torch.Tensor:
    """`x ** 7` as `lax.integer_pow` computes it."""
    x2 = x * x
    return (x * x2) * (x2 * x2)


def _hue(b: torch.Tensor, ap: torch.Tensor) -> torch.Tensor:
    h = torch.atan2(b, ap)
    h = torch.where(h < 0.0, h + _DEG360, h)
    return torch.where((b == 0.0) & (ap == 0.0), torch.zeros_like(h), h)


def cie2000_sq_planes(l1, a1, b1, l2, a2, b2, c1=None) -> torch.Tensor:
    """Squared CIEDE2000 over planes (tensors that broadcast together).
    `c1`, the first colour's chroma, may be passed in when it is hoisted
    out of a centroid loop; it is the same expression either way."""
    if c1 is None:
        c1 = torch.sqrt(a1 * a1 + b1 * b1)
    c2 = torch.sqrt(a2 * a2 + b2 * b2)
    bar_c7 = _pow7((c1 + c2) * 0.5)
    g = 0.5 * (1.0 - torch.sqrt(bar_c7 / (bar_c7 + _POW25_7)))

    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = torch.sqrt(a1p * a1p + b1 * b1)
    c2p = torch.sqrt(a2p * a2p + b2 * b2)
    h1p = _hue(b1, a1p)
    h2p = _hue(b2, a2p)

    dlp = l2 - l1
    dcp = c2p - c1p
    dh = h2p - h1p
    abs_dh = torch.abs(dh)
    dhp = torch.where(
        abs_dh <= _DEG180,
        dh,
        torch.where(h2p <= h1p, dh + _DEG360, dh - _DEG360),
    )
    c12 = c1p * c2p
    zero = c12 == 0.0
    dhp = torch.where(zero, torch.zeros_like(dhp), dhp)
    d_big_h = 2.0 * torch.sqrt(c12) * torch.sin(dhp * 0.5)

    bar_lp = (l1 + l2) * 0.5
    bar_cp = (c1p + c2p) * 0.5
    h_sum = h1p + h2p
    bar_h = torch.where(
        abs_dh > _DEG180,
        torch.where(h_sum < _DEG360, (h_sum + _DEG360) * 0.5, (h_sum - _DEG360) * 0.5),
        h_sum * 0.5,
    )
    bar_h = torch.where(zero, h_sum, bar_h)

    t = (
        1.0
        - 0.17 * torch.cos(bar_h - _RAD30)
        + 0.24 * torch.cos(2.0 * bar_h)
        + 0.32 * torch.cos(3.0 * bar_h + _RAD6)
        - 0.20 * torch.cos(4.0 * bar_h - _RAD63)
    )
    arg = div(bar_h - _RAD275, _RAD25)
    d_theta = _RAD30 * torch.exp(-(arg * arg))
    bar_cp7 = _pow7(bar_cp)
    r_c = 2.0 * torch.sqrt(bar_cp7 / (bar_cp7 + _POW25_7))
    lm = bar_lp - 50.0
    lm50 = lm * lm
    s_l = 1.0 + (0.015 * lm50) / torch.sqrt(20.0 + lm50)
    s_c = 1.0 + 0.045 * bar_cp
    s_h = 1.0 + 0.015 * bar_cp * t
    r_t = -torch.sin(2.0 * d_theta) * r_c

    tl = dlp / s_l
    tc = dcp / s_c
    th = d_big_h / s_h
    return torch.clamp(tl * tl + tc * tc + th * th + r_t * tc * th, min=0.0)


def distance_cie2000_sq(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """Squared CIEDE2000. Always >= 0, and the square root is monotone, so
    an argmin over it selects the same entry as over the full metric."""
    return cie2000_sq_planes(
        lab1[..., 0], lab1[..., 1], lab1[..., 2], lab2[..., 0], lab2[..., 1], lab2[..., 2]
    )


def distance_cie2000(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """CIEDE2000 delta-E between Lab colours (last axis `[L, a, b]`)."""
    return torch.sqrt(distance_cie2000_sq(lab1, lab2))


METRICS = {
    "cie94": (distance_cie94, distance_cie94_sq),
    "cie2000": (distance_cie2000, distance_cie2000_sq),
}


def metric_fns(name: str):
    """`(distance, distance_sq)` for a metric name."""
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(
            f"unknown delta-E metric {name!r}; expected one of {sorted(METRICS)}"
        ) from None
