"""PyTorch port vs the JAX package: the fast tiers (`fast=True`).

The port's plain twins (the specs of the CUDA kernels' factorized-CIE94
and pruned-CIEDE2000 modes) are held against the reference's Pallas
kernels run in interpret mode, on inputs made from numpy seeds. (The
gates, the training and the slice as a whole are in
tests/test_torch_fast_api.py.) Every deviation is counted and printed.
Bars:

- `factor_g_table`, `screen_factors`, `screen_score` against the
  reference's eager functions: 0 entries differ in bits (both run one
  IEEE float32 operation after another).
- assign twin against `fused_assign_packed(fast=True, interpret=True)`:
  flipped indices at most 1e-3 of the pixels (the reference's own bar
  between its tiers, tests/test_kernels.py:753, 786, 1059: the jitted
  XLA-CPU kernel may contract the score's multiply-add pairs, and the
  score is a difference of large terms, so near-ties are commoner than
  under the exact form), every index `< k_active`.
- meld twin against `fused_meld_packed(fast=True, interpret=True)`: at
  most 1e-3 of the pixels differ; those within 1 u8 step are counted
  apart from those whose two closest centroids changed.
- accumulator twin against `lloyd_accumulate(fast=True, interpret=True)`:
  pixels that moved between clusters at most 1e-3 of the pixels; sums
  within `1e-5 * (|want| + 128 * count)` (the bar of
  tests/test_torch_lloyd.py) plus 128 (and, for the inertia column, one
  squared distance: 1e4) per moved pixel.

The interpret-mode kernels at kp > 16 cost seconds of compilation each,
so each case is compiled once and serves all its `k_active` values, and
the reference's pruned screen runs one centroid per loop trip (the
module's fixture).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import kernels as ref_k
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu.ops.quantize import dither_threshold as ref_threshold
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.utils.packing import (
    pack_bits,
    unpack_rgb24_tile_words,
    unpack_tile_words,
)

torch.set_num_threads(2)

BAR = 1e-3  # the fast tiers' deviation bar, as a fraction of the pixels
H, W = 37, 53  # ragged: 1961 pixels in one 16384-pixel tile


@pytest.fixture(scope="module", autouse=True)
def _short_prune_loop():
    """The reference's pruned screen unrolls `PRUNE_CHUNK` (32) insertions
    of the top-m list per loop trip. In interpret mode the XLA compile of
    that body sets these tests' time, whatever the image size: 30-37 s for
    each pruned case at m = 16 or in the accumulator. One trip per
    centroid walks the same centroids in the same order and computes the
    same lists (the loop form changes no result, tests/conftest.py), and
    compiles in under 10 s."""
    prev = ref_k.set_loop_knobs(prune_chunk=1)
    yield
    ref_k.set_loop_knobs(prune_chunk=prev[5])


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _case(k, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pal = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (k, 3), dtype=np.uint8))))
    return rgb, pal


def _rgba(rgb):
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def _lab_pixels(n, seed):
    """`[n, 3]` float32 Lab of random sRGB pixels, a tenth of them one
    colour, so that exact ties occur."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    rgb[: n // 10] = rgb[0]
    return np.array(ref_lab(jnp.asarray(rgb)))


# --- the score's parts ------------------------------------------------------


def test_factor_g_table_bit_equal():
    _, pal = _case(64, seed=1)
    pal[5, 1:] = 0.0  # a grey centroid: C2 = 0
    want = np.asarray(ref_k.factor_g_table(jnp.asarray(pal)))
    got = kernels.factor_g_table(torch.from_numpy(pal)).numpy()
    assert got.shape == want.shape == (64, 7) and got.dtype == np.float32
    differ = int((_bits(got) != _bits(want)).sum())
    print(f"factor_g_table: {differ} of {got.size} entries differ in bits")
    assert differ == 0
    # Column 3 squares the rounded root; column 6 is the sum itself.
    assert (_bits(got[:, 3]) != _bits(got[:, 6])).any()


def test_screen_factors_and_score_bit_equal():
    lab = _lab_pixels(4096, seed=2)
    lab[7, 1:] = 0.0  # a grey pixel: c1 = 0
    _, pal = _case(24, seed=3)
    l, a, b = (jnp.asarray(lab[:, c]) for c in range(3))
    # One chroma for both: XLA-CPU's and torch's `sqrt(a * a + b * b)`
    # differ by an ulp on ~0.5% of random pixels, which is not under test.
    c1 = jnp.sqrt(a * a + b * b)
    want = ref_k._screen_factor_planes(l, a, b, c1)
    tl, ta, tb = (torch.from_numpy(lab[:, c].copy()) for c in range(3))
    got = kernels.screen_factors(tl, ta, tb, torch.from_numpy(np.array(c1)))
    differ = sum(int((_bits(g.numpy()) != _bits(w)).sum()) for g, w in zip(got, want))
    print(f"screen_factors: {differ} of {6 * 4096} entries differ in bits")
    assert differ == 0
    gtab = kernels.factor_g_table(torch.from_numpy(pal))
    score = ref_k._screen_k_fn(jnp.asarray(gtab.numpy()), want)
    differ = sum(
        int((_bits(kernels.screen_score(got, gtab[k]).numpy()) != _bits(score(k))).sum())
        for k in range(24)
    )
    print(f"screen_score: {differ} of {24 * 4096} scores differ in bits")
    assert differ == 0


def test_predicates_match_reference():
    for fast in (False, True):
        for metric in ("cie94", "cie2000"):
            for kp in (1, 16, 17, 128, 129, 512, 513, 1024):
                assert kernels.factor_mode(fast, metric, kp) == ref_k._factor_mode(fast, metric, kp)
                assert kernels.prune_mode(fast, metric, kp) == ref_k._prune_mode(fast, metric, kp)
                assert kernels.prune_m_for(kp) == ref_k.prune_m_for(kp)
    assert kernels.accum_tier(True, "cie94", 8, False) == "factor"
    assert kernels.accum_tier(True, "cie94", 8, True) == "algebraic"
    assert kernels.accum_tier(True, "cie2000", 16, True) == "exact"
    assert kernels.accum_tier(True, "cie2000", 17, True) == "prune"
    assert kernels.accum_tier(False, "cie94", 64, False) == "exact"


# --- assign -------------------------------------------------------------------


def _indices(words, k):
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    n_pad = words.size * (32 // bits)
    return unpack_tile_words(np.asarray(words), 1, n_pad, bits, rows).reshape(-1)


ASSIGN_CASES = {
    # name: (kp, metric, mode, k_active values sharing one compilation)
    "cie94-k17-replace": (17, "cie94", "replace", (None,)),
    "cie94-k24-dither": (24, "cie94", "dither", (None, 20)),
    "cie94-k64-replace": (64, "cie94", "replace", (None, 40)),
    "cie94-k129-dither": (129, "cie94", "dither", (100,)),
    "cie2000-k24-dither": (24, "cie2000", "dither", (None, 20, 5)),
    "cie2000-k129-replace": (129, "cie2000", "replace", (None, 100, 12)),  # m = 16
}


@pytest.mark.parametrize("case", sorted(ASSIGN_CASES))
def test_assign_twin_matches_pallas_kernel(case):
    kp, metric, mode, k_actives = ASSIGN_CASES[case]
    rgb, pal = _case(kp, seed=100 + kp)
    for k_active in k_actives:
        thr = float(ref_threshold(jnp.asarray(pal), k_active, metric)) if mode == "dither" else 0.0
        # An int `k_active` always: `None` would compile the kernel anew.
        want = ref_k.fused_assign_packed(
            jnp.asarray(_rgba(rgb)), jnp.asarray(pal), thr,
            k_active=kp if k_active is None else k_active, mode=mode,
            metric=metric, fast=True, interpret=True,
        )
        got = kernels.assign_packed_reference(
            torch.from_numpy(rgb), torch.from_numpy(pal.copy()), thr, k_active, mode,
            metric=metric, fast=True,
        ).numpy()
        assert got.shape == want.shape and got.dtype == np.int32
        gi, wi = _indices(got, kp), _indices(want, kp)
        flips = int((gi != wi).sum())
        print(f"{case} k_active={k_active}: {flips} flipped of {gi.size} indices")
        assert flips <= BAR * H * W
        assert gi.max() < (kp if k_active is None else k_active)


# --- meld ---------------------------------------------------------------------


@pytest.mark.parametrize("kp,metric,k_actives", [(24, "cie94", (None, 20)),
                                                 (129, "cie94", (100,)),
                                                 (129, "cie2000", (None, 100, 5))])  # m = 16
def test_meld_twin_matches_pallas_kernel(kp, metric, k_actives):
    """Under prune, `k_active = 5` leaves 11 of the 16 candidate slots
    unfilled. The m = 8 list is the assign's, held above at kp = 24."""
    rgb, pal = _case(kp, seed=200 + kp)
    for k_active in k_actives:
        want = ref_k.fused_meld_packed(
            jnp.asarray(_rgba(rgb)), jnp.asarray(pal),
            k_active=kp if k_active is None else k_active, metric=metric,
            fast=True, interpret=True,
        )
        got = kernels.meld_packed_reference(
            torch.from_numpy(rgb), torch.from_numpy(pal.copy()), k_active, metric, fast=True
        ).numpy()
        assert got.shape == want.shape
        rows = kernels.quant_tile_rows(kp)
        a = unpack_rgb24_tile_words(got, H, W, rows).astype(int)
        b = unpack_rgb24_tile_words(np.asarray(want), H, W, rows).astype(int)
        step = np.abs(a - b).max(-1)
        one, more = int((step == 1).sum()), int((step > 1).sum())
        print(f"meld {metric} kp={kp} k_active={k_active}: {one} pixels differ by 1 u8 "
              f"step, {more} by more, of {H * W}")
        assert (a[..., 3] == 255).all() and one + more <= BAR * H * W


# --- the accumulator -------------------------------------------------------


ACCUM_N = 5000
ACCUM_CASES = {
    # name: (kp, k_active values, metric, emit_inertia, weighted, bf16)
    "factorized-k8-bf16": (8, (None,), "cie94", False, False, True),
    "factorized-k24": (24, (None, 20), "cie94", False, False, False),
    "algebraic-k8-weighted": (8, (None, 5), "cie94", True, True, False),
    "pruned-k24-inertia": (24, (None, 20, 6), "cie2000", True, False, False),
}


@pytest.mark.parametrize("case", sorted(ACCUM_CASES))
def test_accumulator_twin_matches_pallas_kernel(case):
    """The pruned accumulator at kp > 128 (m = 16) is left to the card,
    where the kernel is held to this twin: the reference unrolls its
    accumulator over kp, and the interpret-mode compilation of that form
    at kp = 129 alone takes 140 s here. The twin's m = 16 branch is the
    one the assign and meld twins share, held above at kp = 129."""
    kp, k_actives, metric, inertia, weighted, bf16 = ACCUM_CASES[case]
    lab = _lab_pixels(ACCUM_N, seed=300 + kp)
    rng = np.random.default_rng(310 + kp)
    cents = lab[rng.choice(ACCUM_N, kp, replace=False)] + rng.normal(0, 2, (kp, 3)).astype(
        np.float32)
    cents[-1] = cents[0]  # a duplicate centroid
    w = rng.integers(0, 4, ACCUM_N).astype(np.float32) if weighted else None
    ref_planes, n = ref_k.pack_lab_planes(jnp.asarray(lab), dtype=jnp.bfloat16 if bf16 else None)
    planes, _ = kernels.pack_lab_planes(torch.from_numpy(lab), torch.bfloat16 if bf16 else None)
    ref_w = None if w is None else ref_k.pack_plane(jnp.asarray(w))
    port_w = None if w is None else kernels.pack_plane(torch.from_numpy(w))
    reference = jax.jit(functools.partial(
        ref_k.lloyd_accumulate, interpret=True, metric=metric, emit_inertia=inertia, fast=True))
    for k_active in k_actives:
        ka = kp if k_active is None else k_active
        want = np.asarray(
            reference(ref_planes, jnp.asarray(cents), n, k_active=ka, weight_planes=ref_w),
            np.float64)
        got = kernels.lloyd_accumulate_reference(
            planes, torch.from_numpy(cents), n, k_active=k_active, weight_planes=port_w,
            metric=metric, emit_inertia=inertia, fast=True,
        ).numpy().astype(np.float64)
        assert got.shape == want.shape == (kp, 5 if inertia else 4)
        assert not got[ka:].any()
        # Weights are at most 3, so a moved pixel shifts two counts by <= 3.
        moved = np.abs(got[:, 3] - want[:, 3]).sum() / 2
        print(f"accumulator {case} k_active={k_active}: count drift {moved} of {ACCUM_N} pixels")
        assert moved <= 3 * BAR * ACCUM_N
        bound = 1e-5 * (np.abs(want) + 128.0 * want[:, 3:4]) + 128.0 * 2 * moved
        assert (np.abs(got - want)[:, :4] <= bound[:, :4]).all()
        if inertia:
            assert (np.abs(got - want)[:, 4] <= 1e-5 * want[:, 4] + 1e-3 + 1e4 * 2 * moved).all()
