"""sRGB <-> CIELAB conversions (D65, Lindbloom constants) in PyTorch.

Port of `kmeans_tpu/ops/colorspace.py`, with the same formulas in the same
float32 operation order:

- sRGB -> Lab goes through the carried 256-entry gamma table
  (`ops/gamma_lut.py`) instead of a `pow` chain: every input is a u8 code,
  and torch's float32 `pow` does not reproduce XLA's bits. The rest is
  `kmeans_tpu/ops/kernels.py::_lab_from_linear_planes`: a left-to-right
  matrix row, a divide by the white point, `pow(t, 1/3)` (not cbrt) with
  the 7.787 linear toe.
- Lab -> sRGB is the exact inverse, with the 0.0031308 gamma threshold.
- `srgb_to_lab`, `srgb_to_linear` and `linear_to_srgb` take float sRGB or
  linear values, as the reference's public functions of those names do;
  their `pow` is torch's, which may differ from XLA's in the last bit.

Divisions by constants use `ops._math.div` (a true division on CUDA too).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kmeans_tpu_torch.ops._math import div
from kmeans_tpu_torch.ops.gamma_lut import compiled_gamma_lut, gamma_lut

# Lindbloom sRGB D65 matrices (kmeans_tpu/ops/colorspace.py:32-43).
RGB_TO_XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)

XYZ_TO_RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)

# D65 reference white, x100 scale (kmeans_tpu/ops/colorspace.py:51).
WHITE_POINT = (95.0489, 100.0, 108.8840)

_LAB_EPS = 0.008856
_LAB_SLOPE = 7.787
_LAB_OFFSET = 16.0 / 116.0


def _mat3(m, v0, v1, v2):
    """A 3x3 matrix applied to three planes, each row summed left to right."""
    return tuple(m[i][0] * v0 + m[i][1] * v1 + m[i][2] * v2 for i in range(3))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    """CIELAB cube root with its linear toe; `pow(t, 1/3)` like the
    reference (kmeans_tpu/ops/colorspace.py:74-83)."""
    return torch.where(
        t > _LAB_EPS,
        torch.clamp(t, min=0.0) ** (1.0 / 3.0),
        _LAB_SLOPE * t + _LAB_OFFSET,
    )


def lab_from_linear(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Matrix and cube-root half of sRGB -> Lab over linear planes already
    scaled by 100 (kmeans_tpu/ops/kernels.py::_lab_from_linear_planes).
    Returns the `(L, a, b)` planes."""
    x, y, z = _mat3(RGB_TO_XYZ, r, g, b)
    fx = _lab_f(div(x, WHITE_POINT[0]))
    fy = _lab_f(div(y, WHITE_POINT[1]))
    fz = _lab_f(div(z, WHITE_POINT[2]))
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB gamma expansion of values in [0, 1]
    (kmeans_tpu/ops/colorspace.py:59)."""
    c = torch.as_tensor(c).to(torch.float32)
    return torch.where(c > 0.04045, div(c + 0.055, 1.055) ** 2.4, div(c, 12.92))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB gamma compression (kmeans_tpu/ops/colorspace.py:65),
    clamped at 0 before the fractional power."""
    c = torch.as_tensor(c).to(torch.float32)
    safe = torch.clamp(c, min=0.0)
    return torch.where(
        c > 0.0031308, 1.055 * safe ** (1.0 / 2.4) - 0.055, 12.92 * c
    )


def srgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """Float sRGB in [0, 1] `[..., 3]` -> float32 Lab `[..., 3]`
    (kmeans_tpu/ops/colorspace.py:92): gamma by `srgb_to_linear`, then
    `lab_from_linear`."""
    lin = srgb_to_linear(rgb) * 100.0
    return torch.stack(lab_from_linear(lin[..., 0], lin[..., 1], lin[..., 2]), -1)


def srgb8_to_lab(rgb8: torch.Tensor) -> torch.Tensor:
    """uint8 sRGB `[..., 3]` -> float32 Lab `[..., 3]`, gamma by table."""
    lut = gamma_lut(rgb8.device)
    idx = rgb8.to(torch.int64)
    lin = lut[idx]
    return torch.stack(lab_from_linear(lin[..., 0], lin[..., 1], lin[..., 2]), -1)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """`a * b + c` with one rounding to float32, as XLA-CPU contracts a
    product and a sum into a fused multiply-add: the product of two
    float32 values is exact in float64. `b` and `c` may be floats that
    are float32 values. The sum rounds once in float64 first only when
    its exact value spans more than 53 bits; that moves the float32 result
    on the rare exact halfway case."""
    a = a.double()
    if not isinstance(c, torch.Tensor):
        return (a * (b.double() if isinstance(b, torch.Tensor) else b)).add_(c).float()
    if isinstance(b, torch.Tensor):
        return torch.addcmul(c.double(), a, b.double()).float()
    return torch.add(c.double(), a, alpha=b).float()


def _f32(value: float) -> float:
    return float(np.float32(value))


# The constants XLA folds `x / white`, `7.787 * (x / white)` and `1 / 3`
# into (kmeans_tpu/ops/colorspace.py:92-106, compiled on the CPU).
_INV_WHITE = tuple(_f32(np.float32(1.0) / np.float32(w)) for w in WHITE_POINT)
_TOE_SLOPE = tuple(_f32(np.float32(_LAB_SLOPE) * np.float32(inv)) for inv in _INV_WHITE)
_THIRD = _f32(1.0 / 3.0)


def srgb8_to_lab_compiled(rgb8: torch.Tensor, inline: bool = False):
    """uint8 sRGB `[..., 3]` -> float32 Lab `[..., 3]` as the reference's
    training executables compute it, jitted on the CPU
    (kmeans_tpu/api.py:150 `_train_jit`, and every executable that runs
    `srgb8_to_lab` and the seeding together): the gamma from
    `compiled_gamma_lut`; each matrix row `fma(b, m2, fma(r, m0, g *
    m1))`; the white point and the toe's slope folded into multiplies
    (`_INV_WHITE`, `_TOE_SLOPE`), the toe `fma(x, slope, 16 / 116)`; `L =
    fma(fy, 116, -16)`. The cube root is the correctly rounded
    `t ** f32(1 / 3)` (through float64): XLA's own `pow` differs from it on
    about 0.07% of inputs, so about 0.2% of the 2^24 colours are an ulp or
    more apart from the reference's; every other colour has its bits.

    With `inline`, also returns `[..., 3]` float64: L* (whose last step
    is an add, so nothing contracts it further), `500 * (fx - fy)` and
    `200 * (fy - fz)` unrounded. The reference's first seeding map
    recomputes a pixel's Lab inline and contracts `500 * (fx - fy) - a_c`
    into one fused multiply-add, so its distance from a pixel to its own
    colour is the rounding residue of a* and b*, not 0
    (`models/kmeans.py::_first_map_compiled`)."""
    lin = compiled_gamma_lut(rgb8.device)[rgb8.to(torch.int64)]
    r, g, b = lin[..., 0:1], lin[..., 1:2], lin[..., 2:3]
    m0, m1, m2, inv, slope = _compiled_constants(lin.device)
    # The three rows at once, `[..., 3]`: X, Y, Z in the last axis.
    x = fma(b, m2, fma(r, m0, g * m1))
    t = x * inv
    cube = torch.pow(torch.clamp(t, min=0.0).double(), _THIRD).float()
    fx, fy, fz = torch.where(t > _LAB_EPS, cube, fma(x, slope, _f32(_LAB_OFFSET))).unbind(-1)
    dxy, dyz = fx - fy, fy - fz
    lab = torch.stack([fma(fy, 116.0, -16.0), dxy * 500.0, dyz * 200.0], -1)
    if not inline:
        return lab
    return lab, torch.stack([lab[..., 0].double(), dxy.double() * 500.0,
                             dyz.double() * 200.0], -1)


@functools.lru_cache(maxsize=None)
def _compiled_constants(device: torch.device):
    """`srgb8_to_lab_compiled`'s per-row constants on `device`, uploaded
    once: the matrix's columns (the first and last as float64 factors of
    the multiply-adds), `_INV_WHITE` and `_TOE_SLOPE`."""
    cols = [[_f32(row[i]) for row in RGB_TO_XYZ] for i in range(3)]
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    f64 = functools.partial(torch.tensor, dtype=torch.float64, device=device)
    return f64(cols[0]), f32(cols[1]), f64(cols[2]), f32(_INV_WHITE), f64(_TOE_SLOPE)

def _lab_f_inv(t: torch.Tensor) -> torch.Tensor:
    t3 = t * t * t
    return torch.where(t3 > _LAB_EPS, t3, div(t - _LAB_OFFSET, _LAB_SLOPE))


def lab_to_srgb(lab: torch.Tensor) -> torch.Tensor:
    """CIELAB `[..., 3]` -> sRGB in [0, 1] (clipped); the inverse of
    `srgb8_to_lab` (kmeans_tpu/ops/colorspace.py:110-125)."""
    lab = lab.to(torch.float32)
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = div(l + 16.0, 116.0)
    fx = div(a, 500.0) + fy
    fz = fy - div(b, 200.0)
    x = _lab_f_inv(fx) * (WHITE_POINT[0] / 100.0)
    y = _lab_f_inv(fy) * (WHITE_POINT[1] / 100.0)
    z = _lab_f_inv(fz) * (WHITE_POINT[2] / 100.0)
    lin = torch.stack(_mat3(XYZ_TO_RGB, x, y, z), -1)
    return torch.clamp(linear_to_srgb(lin), 0.0, 1.0)


def lab_to_srgb8(lab: torch.Tensor) -> torch.Tensor:
    """Lab -> uint8 sRGB, rounding half to even like `jnp.round`."""
    return torch.round(lab_to_srgb(lab) * 255.0).to(torch.uint8)


def srgb8_to_lab_np(rgb8: np.ndarray) -> np.ndarray:
    """uint8 sRGB -> Lab in numpy float32, for tiny host-side work (palette
    sorting, user colours). Same formulas as
    `kmeans_tpu/ops/colorspace.py::srgb8_to_lab_np`, re-implemented here."""
    c = np.asarray(rgb8, np.float32) / np.float32(255.0)
    lin = np.where(
        c > 0.04045,
        ((c + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4),
        c / np.float32(12.92),
    ) * np.float32(100.0)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    planes = []
    for row, wp in zip(RGB_TO_XYZ, WHITE_POINT):
        t = (
            np.float32(row[0]) * r + np.float32(row[1]) * g + np.float32(row[2]) * b
        ) / np.float32(wp)
        planes.append(
            np.where(
                t > _LAB_EPS,
                np.maximum(t, 0) ** np.float32(1.0 / 3.0),
                np.float32(_LAB_SLOPE) * t + np.float32(_LAB_OFFSET),
            )
        )
    fx, fy, fz = planes
    return np.stack(
        [116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], axis=-1
    ).astype(np.float32)
