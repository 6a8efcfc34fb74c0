"""The dither threshold's first-trigger scan on the CPU.

`csrc/dither_threshold.cu` scores a window of candidates at once against
the walk's state, applies the window's first candidate that triggers an
update and starts again just after it. Its plain model,
`tools/threshold_walk.py::first_trigger_walk` (no entry point calls it),
walks the same rounds with the port's distances, and is held here:

- to the serial twin `dither_threshold_reference` bit for bit, under
  Hypothesis, with fixed windows of 32 J candidates (J = 1 and 4, one
  warp) and with the kernel's growing and shrinking window (slots of 1, 3
  and 32 candidates, up to 4 warps), on random palettes, palettes whose
  every step updates the walk, duplicates, NaN and +-inf entries, chromas
  of 1e-25, `k_active` < kp and k = 1, 2, 3, under both metrics. Windows are scored
  in calls of 15 candidates (`piece`): ATen's vectorized CPU `atan2` can
  differ from the scalar one the twin runs by an ulp;
- to the JAX package's `dither_threshold` on seeded palettes, within the
  1e-6 relative the port's twin keeps to it (`tests/test_torch_quantize.py`);
- `count_updates` to the walk's own count, and the every-step palette to
  k - 2 updates.

The kernel itself runs only on a card: `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kmeans_tpu.ops import quantize as ref_q
from kmeans_tpu_torch.ops.quantize import dither_threshold_reference
from kmeans_tpu_torch.tools.threshold_walk import (
    count_updates,
    every_step_palette,
    first_trigger_walk,
)

METRICS = ("cie94", "cie2000")
KINDS = ("random", "every_step", "duplicates", "nan_inf", "k_active", "tiny")
# (slot, warps): fixed windows of 32 J (J = 1, 4) and the kernel's adaptive
# window on narrow slots, so that small palettes span many rounds.
WINDOWS = ((32, 1), (128, 1), (1, 4), (3, 4), (32, 4))
PIECE = 15  # candidates a distance call: ATen's scalar path


def _palette(kind, k, seed):
    """`(palette [k, 3] float32, k_active)` of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "every_step":
        return every_step_palette(k), k
    pal = np.stack([rng.uniform(0, 100, k), rng.uniform(-60, 60, k),
                    rng.uniform(-60, 60, k)], axis=1).astype(np.float32)
    if kind == "duplicates" and k > 1:
        pal[k // 2:] = pal[: k - k // 2]
        pal[rng.integers(0, k, k // 3)] = pal[0]
    if kind == "nan_inf":
        specials = (np.nan, np.inf, -np.inf)
        for i in rng.choice(k, min(k, 3), replace=False):
            pal[i, rng.integers(0, 3)] = specials[rng.integers(0, 3)]
    if kind == "tiny":
        pal[0] = (50.0, 1e-25, 0.0)
        pal[rng.integers(0, k)] = (50.0, 0.0, -1e-30)
    k_active = max(1, int(rng.integers(1, k + 1))) if kind == "k_active" else k
    return torch.from_numpy(pal), k_active


def _bits(x: torch.Tensor) -> int:
    return int(x.reshape(()).view(torch.int32))


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(KINDS), metric=st.sampled_from(METRICS),
       k=st.one_of(st.sampled_from([1, 2, 3]), st.integers(4, 48)),
       window=st.sampled_from(WINDOWS), seed=st.integers(0, 2**31 - 1))
def test_scan_equals_the_serial_walk(kind, metric, k, window, seed):
    pal, k_active = _palette(kind, k, seed)
    if kind == "every_step" and metric == "cie2000":
        pal, k_active = pal[: min(k, 24)], min(k, 24)  # rounds = k: keep it cheap
    slot, warps = window
    got, updates, rounds = first_trigger_walk(pal, k_active, metric, slot, warps, PIECE)
    want = dither_threshold_reference(pal, k_active, metric)
    assert _bits(got) == _bits(want)
    steps = max(0, min(pal.shape[0], k_active) - 2)
    assert updates <= rounds <= steps
    if kind == "every_step":
        assert updates == steps


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [2, 40, 300])
def test_scan_on_large_windows(metric, k):
    """Windows wider than the palette and the kernel's widest (8 warps of
    32), on random palettes past one window."""
    pal, _ = _palette("random", k, 7 + k)
    want = _bits(dither_threshold_reference(pal, None, metric))
    for slot, warps in ((32, 8), (4096, 1)):
        got, _, _ = first_trigger_walk(pal, None, metric, slot, warps, PIECE)
        assert _bits(got) == want


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k,k_active", [(1, 1), (3, 3), (17, 17), (40, 40), (40, 23)])
def test_scan_matches_the_reference(k, k_active, metric):
    pal, _ = _palette("random", k, 100 + k)
    want = float(ref_q.dither_threshold(jnp.asarray(pal.numpy()), k_active, metric))
    got, _, _ = first_trigger_walk(pal, k_active, metric, 32, 4, PIECE)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind,k", [("random", 200), ("every_step", 60), ("duplicates", 90)])
def test_count_updates(kind, k, metric):
    pal, _ = _palette(kind, k, 3)
    assert count_updates(pal, metric) == first_trigger_walk(pal, None, metric, 32, 1, PIECE)[1]
    if kind == "every_step":
        assert count_updates(pal, metric) == k - 2
