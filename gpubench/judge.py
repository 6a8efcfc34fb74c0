"""The comparison that decides `correct`: the program's sampled outputs
against the plain reference's, pixel for pixel.

`numbers(pairs)` takes `(output, reference)` pairs of uint8 RGBA arrays of
one shape and gives:

- `pixels_differing`: pixels whose RGBA differs in any channel, summed
  over the pairs;
- `share_differing`: the largest share of an output's pixels that differ;
- `mean_abs_diff`: the largest mean |difference| over an output's
  channels, in u8 steps;
- `max_abs_diff`: the largest |difference| of any channel.

`verdict(numbers, limits)` holds each number that `limits["compare"]`
names to its limit (number <= limit) and returns `(correct, checks)`,
`checks` being `{name: {"value": .., "limit": ..}}` in the limits' order.
"""

from __future__ import annotations

import numpy as np

NAMES = ("pixels_differing", "share_differing", "mean_abs_diff", "max_abs_diff")


def numbers(pairs) -> dict:
    out = {"pixels_differing": 0, "share_differing": 0.0, "mean_abs_diff": 0.0,
           "max_abs_diff": 0}
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            raise ValueError(f"output shape {got.shape} against the reference's {want.shape}")
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        differing = int(diff.any(axis=-1).sum())
        out["pixels_differing"] += differing
        out["share_differing"] = max(out["share_differing"], differing / (got.size // 4))
        out["mean_abs_diff"] = max(out["mean_abs_diff"], float(diff.mean()))
        out["max_abs_diff"] = max(out["max_abs_diff"], int(diff.max()))
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    checks = {name: {"value": values[name], "limit": limit}
              for name, limit in limits["compare"].items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
