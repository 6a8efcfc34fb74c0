"""Wu's colour quantizer (host numpy), for `algo=Algorithm.WU`.

A copy of `kmeans_tpu/models/wu.py` (`_moments:36` through
`extract_palette_wu:164`), kept inside the port because importing
`kmeans_tpu` imports JAX. The same float64 numpy operations in the same
order give the reference's palette.

Xiaolin Wu's method (Graphics Gems II, 1991) greedily partitions RGB space
into `color_count` boxes, always splitting the box with the largest colour
variance at the plane that minimises the summed squared error of the two
halves. All statistics come from cumulative 3-D moment tables over a
32^3 histogram, so any candidate box costs O(1) by inclusion-exclusion.
"""

from __future__ import annotations

import numpy as np

# 5 bits per channel -> 32 cells + 1 leading zero-pad row for cumsum.
_BITS = 5
_SIDE = (1 << _BITS) + 1  # 33


class _Box:
    __slots__ = ("r0", "r1", "g0", "g1", "b0", "b1", "vol")

    def __init__(self, r0, r1, g0, g1, b0, b1):
        self.r0, self.r1 = r0, r1
        self.g0, self.g1 = g0, g1
        self.b0, self.b1 = b0, b1
        self.vol = (r1 - r0) * (g1 - g0) * (b1 - b0)


def _moments(rgb: np.ndarray):
    """Cumulative moment tables over the 32^3 histogram.

    Returns (wt, mr, mg, mb, m2): weight, per-channel sums and squared-norm
    sum, each `[33, 33, 33]` with index i meaning "cells < i" after the
    cumulative sum (classic Wu layout: pad + inclusive cumsum)."""
    q = rgb.astype(np.int64) >> (8 - _BITS)  # [N, 3] in [0, 32)
    flat = (q[:, 0] << (2 * _BITS)) | (q[:, 1] << _BITS) | q[:, 2]
    n_cells = 1 << (3 * _BITS)

    wt = np.bincount(flat, minlength=n_cells).astype(np.float64)
    r = rgb[:, 0].astype(np.float64)
    g = rgb[:, 1].astype(np.float64)
    b = rgb[:, 2].astype(np.float64)
    mr = np.bincount(flat, weights=r, minlength=n_cells)
    mg = np.bincount(flat, weights=g, minlength=n_cells)
    mb = np.bincount(flat, weights=b, minlength=n_cells)
    m2 = np.bincount(flat, weights=r * r + g * g + b * b, minlength=n_cells)

    def cum(a):
        a = a.reshape(32, 32, 32)
        out = np.zeros((_SIDE, _SIDE, _SIDE), np.float64)
        out[1:, 1:, 1:] = a.cumsum(0).cumsum(1).cumsum(2)
        return out

    return cum(wt), cum(mr), cum(mg), cum(mb), cum(m2)


def _vol(box: _Box, m: np.ndarray) -> float:
    """Sum of moment `m` over `box` by 8-corner inclusion-exclusion."""
    r0, r1, g0, g1, b0, b1 = box.r0, box.r1, box.g0, box.g1, box.b0, box.b1
    return (
        m[r1, g1, b1] - m[r1, g1, b0] - m[r1, g0, b1] + m[r1, g0, b0]
        - m[r0, g1, b1] + m[r0, g1, b0] + m[r0, g0, b1] - m[r0, g0, b0]
    )


def _bottom(box: _Box, axis: int, m: np.ndarray) -> float:
    """Moment sum over the box face at the low end of `axis` (the part that
    does NOT vary with the cut position)."""
    r0, r1, g0, g1, b0, b1 = box.r0, box.r1, box.g0, box.g1, box.b0, box.b1
    if axis == 0:
        return -(m[r0, g1, b1] - m[r0, g1, b0] - m[r0, g0, b1] + m[r0, g0, b0])
    if axis == 1:
        return -(m[r1, g0, b1] - m[r1, g0, b0] - m[r0, g0, b1] + m[r0, g0, b0])
    return -(m[r1, g1, b0] - m[r1, g0, b0] - m[r0, g1, b0] + m[r0, g0, b0])


def _top(box: _Box, axis: int, pos: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Moment sum over the face at cut position(s) `pos` along `axis`."""
    r0, r1, g0, g1, b0, b1 = box.r0, box.r1, box.g0, box.g1, box.b0, box.b1
    if axis == 0:
        return m[pos, g1, b1] - m[pos, g1, b0] - m[pos, g0, b1] + m[pos, g0, b0]
    if axis == 1:
        return m[r1, pos, b1] - m[r1, pos, b0] - m[r0, pos, b1] + m[r0, pos, b0]
    return m[r1, g1, pos] - m[r1, g0, pos] - m[r0, g1, pos] + m[r0, g0, pos]


def _variance(box: _Box, wt, mr, mg, mb, m2) -> float:
    """Weighted variance (SSE) of the colors in `box`."""
    w = _vol(box, wt)
    if w <= 0:
        return 0.0
    dr, dg, db = _vol(box, mr), _vol(box, mg), _vol(box, mb)
    return _vol(box, m2) - (dr * dr + dg * dg + db * db) / w


def _maximize(box: _Box, axis: int, wt, mr, mg, mb):
    """Best cut along `axis`: maximizes sum of squared-mean terms of the two
    halves (equivalently minimizes their combined SSE). Returns
    (score, cut) with cut == -1 if no valid cut exists."""
    lo = (box.r0, box.g0, box.b0)[axis]
    hi = (box.r1, box.g1, box.b1)[axis]
    if hi - lo < 2:
        return -1.0, -1
    pos = np.arange(lo + 1, hi)

    whole_w = _vol(box, wt)
    whole_r, whole_g, whole_b = _vol(box, mr), _vol(box, mg), _vol(box, mb)
    base_w = _bottom(box, axis, wt)
    base_r = _bottom(box, axis, mr)
    base_g = _bottom(box, axis, mg)
    base_b = _bottom(box, axis, mb)

    half_w = base_w + _top(box, axis, pos, wt)
    half_r = base_r + _top(box, axis, pos, mr)
    half_g = base_g + _top(box, axis, pos, mg)
    half_b = base_b + _top(box, axis, pos, mb)
    rest_w = whole_w - half_w
    rest_r = whole_r - half_r
    rest_g = whole_g - half_g
    rest_b = whole_b - half_b

    valid = (half_w > 0) & (rest_w > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        score = (
            (half_r**2 + half_g**2 + half_b**2) / half_w
            + (rest_r**2 + rest_g**2 + rest_b**2) / rest_w
        )
    score = np.where(valid, score, -1.0)
    best = int(score.argmax())
    if score[best] < 0:
        return -1.0, -1
    return float(score[best]), int(pos[best])


def _cut(box: _Box, wt, mr, mg, mb) -> _Box | None:
    """Split `box` in place at its best (axis, position); returns the new
    upper box, or None if the box cannot be split."""
    scores = [_maximize(box, ax, wt, mr, mg, mb) for ax in range(3)]
    axis = int(np.argmax([s for s, _ in scores]))
    score, cut = scores[axis]
    if cut < 0:
        return None
    if axis == 0:
        new = _Box(cut, box.r1, box.g0, box.g1, box.b0, box.b1)
        box.r1 = cut
    elif axis == 1:
        new = _Box(box.r0, box.r1, cut, box.g1, box.b0, box.b1)
        box.g1 = cut
    else:
        new = _Box(box.r0, box.r1, box.g0, box.g1, cut, box.b1)
        box.b1 = cut
    box.vol = (box.r1 - box.r0) * (box.g1 - box.g0) * (box.b1 - box.b0)
    new.vol = (new.r1 - new.r0) * (new.g1 - new.g0) * (new.b1 - new.b0)
    return new


def extract_palette_wu(rgb: np.ndarray, color_count: int) -> list[tuple[int, int, int, int]]:
    """`[N, 3]` uint8 pixels -> up to `color_count` RGBA tuples."""
    if color_count <= 0:
        return []
    rgb = np.asarray(rgb, dtype=np.uint8).reshape(-1, 3)
    if rgb.shape[0] == 0:
        return []
    wt, mr, mg, mb, m2 = _moments(rgb)

    boxes = [_Box(0, 32, 0, 32, 0, 32)]
    while len(boxes) < color_count:
        # Split the box with the largest variance (skip single-cell boxes).
        order = sorted(
            range(len(boxes)),
            key=lambda i: _variance(boxes[i], wt, mr, mg, mb, m2),
            reverse=True,
        )
        for i in order:
            new = _cut(boxes[i], wt, mr, mg, mb)
            if new is not None:
                boxes.append(new)
                break
        else:
            break  # nothing splittable left

    palette = []
    for box in boxes:
        w = _vol(box, wt)
        if w <= 0:
            continue
        r = int(_vol(box, mr) / w)
        g = int(_vol(box, mg) / w)
        b = int(_vol(box, mb) / w)
        palette.append((r, g, b, 255))
    return sorted(set(palette))
