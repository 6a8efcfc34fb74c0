"""CIE94 colour difference in PyTorch.

Port of `kmeans_tpu/ops/delta_e.py` for the CIE94 metric. It is
asymmetric: the S_C and S_H weights use the chroma of the FIRST argument
(the pixel or candidate), as in every kernel of the reference. The
functions broadcast, so `lab1[..., None, :]` against `lab2[k, 3]` gives a
`[..., k]` distance matrix.

CIEDE2000 is not ported yet (ROADMAP B4); `metric_fns("cie2000")` raises.
"""

from __future__ import annotations

import torch

_K1 = 0.045
_K2 = 0.015


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


METRICS = {"cie94": (distance_cie94, distance_cie94_sq)}


def metric_fns(name: str):
    """`(distance, distance_sq)` for a metric name."""
    if name == "cie2000":
        raise NotImplementedError(
            "CIEDE2000 is not ported to the PyTorch package yet (ROADMAP B4)"
        )
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(
            f"unknown delta-E metric {name!r}; expected one of {sorted(METRICS)}"
        ) from None
