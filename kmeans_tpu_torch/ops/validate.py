"""Kernel validation on the card: each CUDA kernel against its plain twin.

Port of `kmeans_tpu/ops/validate.py` (`validate_kernels:17`), which runs
every Pallas kernel in interpret mode against the XLA formulas. Here each
hand-written kernel of `ops/kernels.py` and `ops/quantize.py` runs on the
CUDA card and is held against its plain PyTorch twin on the same seeded
inputs, with the bars `chip_smoke.py` uses:

- `assign_packed` (replace, dither; the 16-bit tier at k = 300),
  `assign_u8` (the counterpart of the reference's `fused_assign`) and
  `quantize_rgba` (of `fused_quantize`): equal words, indices and RGBA
  under CIE94; under CIEDE2000 every flipped index a near-tie (the twin's
  two distances within 1e-5 of each other, relative);
- `meld_packed`: equal words under CIE94; under CIEDE2000 within 1 u8 step
  on at most 1e-4 of the pixels;
- `lloyd_accumulate` (plain and weighted, both metrics): equal counts, the
  sums within 1e-5 * (|twin| + 128 * count);
- `dither_threshold`: equal bits.

Each check also requires that its wrapper launched the kernel (one more in
`kernels.LAUNCHES_BY_MODE`). On the CPU every wrapper runs its twin, so
the check would compare the twin with itself: without a CUDA device
`validate_kernels` raises. Usable as a library function or as
`python -m kmeans_tpu_torch.ops.validate`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.delta_e import metric_fns
from kmeans_tpu_torch.ops.quantize import (
    bayer_values,
    dither_threshold,
    dither_threshold_reference,
)
from kmeans_tpu_torch.utils.packing import pack_bits, unpack_rgb24_tile_words, unpack_tile_words


def _flips_are_near_ties(rgb, cents, thr, got, want, mode, metric) -> bool:
    """Whether every index that the packed words `got` and `want` give
    differently is a near-tie under the twin's distances."""
    h, w = rgb.shape[0], rgb.shape[1]
    k = cents.shape[0]
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    gi = unpack_tile_words(got.cpu().numpy(), h, w, bits, rows).astype(np.int64).reshape(-1)
    wi = unpack_tile_words(want.cpu().numpy(), h, w, bits, rows).astype(np.int64).reshape(-1)
    flips = np.flatnonzero(gi != wi)
    if not len(flips):
        return True
    lab = srgb8_to_lab(rgb).reshape(-1, 3)
    if mode == "dither":
        lab = lab + (thr * bayer_values(h, w, 0, rgb.device)).reshape(-1, 1)
    _, dist_sq = metric_fns(metric)
    idx = torch.from_numpy(flips).to(rgb.device)
    dg = dist_sq(lab[idx], cents[torch.from_numpy(gi[flips]).to(rgb.device)])
    dw = dist_sq(lab[idx], cents[torch.from_numpy(wi[flips]).to(rgb.device)])
    return bool(((dg - dw).abs() <= 1e-5 * torch.maximum(dg, dw)).all())


def _meld_within_bar(got, want, h, w, k, metric) -> bool:
    if metric == "cie94":
        return bool(torch.equal(got, want))
    rows = kernels.quant_tile_rows(k)
    step = np.abs(unpack_rgb24_tile_words(got.cpu().numpy(), h, w, rows).astype(np.int64)
                  - unpack_rgb24_tile_words(want.cpu().numpy(), h, w, rows)).max(-1)
    return bool(step.max() <= 1 and (step > 0).sum() <= 1e-4 * h * w)


def _accum_within_bar(got, want) -> bool:
    err = (got.double() - want.double()).abs()
    scale = want.double().abs() + 128.0 * want[:, 3:4].double()
    return bool(torch.equal(got[:, 3], want[:, 3]) and (err <= 1e-5 * scale).all())


def validate_kernels(verbose: bool = True) -> bool:
    """Hold every CUDA kernel against its plain twin on seeded inputs on the
    current CUDA device; print one line per check (with `verbose`) and
    return whether all passed. Raises `RuntimeError` without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "validate_kernels holds the CUDA kernels against their plain twins and needs a "
            "CUDA device (on the CPU every wrapper runs its twin)"
        )
    device = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    ok = True

    def report(name: str, match: bool, wrapper: str, before: int) -> None:
        nonlocal ok
        launched = kernels.launches(wrapper) == before + 1
        ok &= match and launched
        if verbose:
            state = "OK" if match and launched else ("MISMATCH" if launched else "NOT LAUNCHED")
            print(f"{name}: {state}", flush=True)

    def image(h, w):
        return torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(device)

    def palette(k):
        rgb = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(device)
        return srgb8_to_lab(rgb).contiguous()

    def threshold(cents, metric):
        before = kernels.launches("dither_threshold")
        got = dither_threshold(cents, metric=metric)
        want = dither_threshold_reference(cents, metric=metric)
        same = bool(np.array_equal(got.cpu().numpy().view(np.uint32),
                                   want.cpu().numpy().view(np.uint32)))
        report(f"dither_threshold {metric:7s} k={cents.shape[0]}", same, "dither_threshold",
               before)
        return got

    def assign(name, wrapper, twin, rgb, cents, thr, mode, metric="cie94"):
        before = kernels.launches(name)
        got = wrapper(rgb, cents, thr, mode=mode, metric=metric)
        want = twin(rgb, cents, thr, mode=mode, metric=metric)
        if metric == "cie94" or name != "assign_packed":
            match = bool(torch.equal(got, want))
        else:
            match = _flips_are_near_ties(rgb, cents, thr, got, want, mode, metric)
        report(f"{name:14s} {metric:7s} mode={mode:7s} k={cents.shape[0]}", match, name, before)

    def meld(rgb, cents, metric="cie94"):
        before = kernels.launches("meld_packed")
        got = kernels.meld_packed(rgb, cents, metric=metric)
        want = kernels.meld_packed_reference(rgb, cents, metric=metric)
        h, w = rgb.shape[0], rgb.shape[1]
        report(f"meld_packed    {metric:7s} k={cents.shape[0]}",
               _meld_within_bar(got, want, h, w, cents.shape[0], metric), "meld_packed", before)

    for mode in ("replace", "dither"):
        for k in (1, 3, 8):
            rgb, cents = image(31, 45), palette(k)
            thr = threshold(cents, "cie94") if mode == "dither" else 0.0
            assign("assign_packed", kernels.assign_packed, kernels.assign_packed_reference,
                   rgb, cents, thr, mode)
            assign("assign_u8", kernels.assign_u8, kernels.assign_u8_reference,
                   rgb, cents, thr, mode)
            assign("quantize_rgba", kernels.quantize_rgba, kernels.quantize_rgba_reference,
                   rgb, cents, thr, mode)
    for k in (1, 3, 8):
        meld(image(31, 45), palette(k))

    # The 16-bit packed tier (256 < k <= 1024, large `find` palettes).
    rgb, cents = image(26, 37), palette(300)
    assign("assign_packed", kernels.assign_packed, kernels.assign_packed_reference,
           rgb, cents, threshold(cents, "cie94"), "dither")

    # CIEDE2000.
    for mode in ("replace", "dither"):
        rgb, cents = image(29, 41), palette(6)
        thr = threshold(cents, "cie2000") if mode == "dither" else 0.0
        assign("assign_packed", kernels.assign_packed, kernels.assign_packed_reference,
               rgb, cents, thr, mode, "cie2000")
    meld(image(29, 41), palette(6), "cie2000")

    # The training accumulator, plain, weighted (0/1: the bucketing path's
    # weight plane) and under CIEDE2000.
    for n, k, weighted, metric in ((5000, 6, False, "cie94"), (5000, 6, True, "cie94"),
                                   (3000, 4, False, "cie2000")):
        lab = torch.from_numpy(rng.normal(50, 25, (n, 3)).astype(np.float32)).to(device)
        cents = torch.from_numpy(rng.normal(50, 25, (k, 3)).astype(np.float32)).to(device)
        planes, n_valid = kernels.pack_lab_planes(lab)
        weight = None
        if weighted:
            weight = kernels.pack_plane(torch.from_numpy(
                (rng.uniform(size=n) > 0.4).astype(np.float32)).to(device))
        before = kernels.launches("lloyd_accumulate")
        got = kernels.lloyd_accumulate(planes, cents, n_valid, None, weight, metric)
        want = kernels.lloyd_accumulate_reference(planes, cents, n_valid, None, weight, metric)
        report(f"lloyd_accumulate {metric:7s} k={k}{' weighted' if weighted else ''}",
               _accum_within_bar(got, want), "lloyd_accumulate", before)
    return ok


if __name__ == "__main__":
    sys.exit(0 if validate_kernels() else 1)
