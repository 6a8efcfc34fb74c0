"""Randomized equivalence soak of the port (the JAX package's
`tools/soak.py`), long-running and not part of the default suite.

It draws random configurations and holds the port's invariants, one
section for each of the reference soak's, in its order (`SECTIONS`, each
citing the lines it follows):

- on the card each hand kernel against its plain twin at random sizes,
  `k`, `k_active` and `row_offset` in every tier, with `chip_smoke.py`'s
  bars: equal words, CIEDE2000 flips only on near-ties, meld within one
  u8 step, accumulator counts equal and sums within 1e-5 of their scale.
  On the CPU the twin is the path, so the kernel sections hold the
  output to `ops/quantize.py::quantize_image` and check index ranges;
- the entry points against each other: bucketed against exact `find`,
  pipeline mode against the default, streamed against whole, the
  micro-batches and the heavy-bucket route against solo calls, the
  sharded batch calls on a mesh of repeats of one device against their
  per-image forms.

A third of the training sections' images are flat regions with fewer
colours than `k` (exact ties in the farthest-point seeding): their
comparisons take no tolerance.

Usage: python -m kmeans_tpu_torch.tools.soak [trials] [--seed N]
       [--budget SECONDS] [--sections NAME,...] [--cpu]
Prints one summary line (`SOAK {...}`: trials, failures and kernel
launches by section, seconds) and exits nonzero on any failure.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from kmeans_tpu_torch import api as api_mod
from kmeans_tpu_torch.api import ImageProcessor, ReduceMode
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.models.octree import ColorTree, extract_palette_octree
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.delta_e import distance_cie2000, metric_fns
from kmeans_tpu_torch.ops.quantize import (
    bayer_values,
    dither_threshold,
    dither_threshold_reference,
    dither_thresholds,
    dither_thresholds_reference,
    quantize_image,
)
from kmeans_tpu_torch.ops.resize import resize_uint8, shrunk_dimensions
from kmeans_tpu_torch.parallel import make_mesh
from kmeans_tpu_torch.utils import imageio, png_py
from kmeans_tpu_torch.utils.packing import (
    pack_bits,
    unpack_rgb24_tile_words,
    unpack_tile_words,
)

MODES = ("replace", "dither", "meld")
NEAR_TIE = 1e-5  # relative distance gap of a permitted CIEDE2000 flip


class Soak:
    """Counts of trials, failures and kernel launches by section, and the
    shared state: the device, the random stream, each section's deadline."""

    def __init__(self, device: str, seed: int):
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.trials = collections.Counter()
        self.failures = collections.Counter()
        self.launches = {}
        self.messages = []
        self.deadline = 0.0
        self.section = ""

    def rounds(self, n: int):
        """Up to `n` trials of the current section, fewer once its share of
        the budget is spent, never fewer than one."""
        for t in range(max(1, n)):
            if t and time.monotonic() > self.deadline:
                return
            self.trials[self.section] += 1
            yield t

    def check(self, ok, what: str) -> None:
        if not ok:
            self.failures[self.section] += 1
            self.messages.append(f"[FAIL] {self.section}: {what}")
            print(self.messages[-1], flush=True)

    def ints(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi))

    def noise(self, h: int, w: int) -> np.ndarray:
        return self.rng.integers(0, 256, (h, w, 4), dtype=np.uint8)

    def image(self, h: int, w: int, flat: bool | None = None) -> tuple:
        """`(Image, flat)`: random noise, or (`flat`, by default one time in
        three) up to six flat regions of random colours: exact ties in the
        seeding at the k the sections draw."""
        if not (self.rng.random() < 1 / 3 if flat is None else flat):
            return Image((w, h), self.noise(h, w)), False
        cols = self.rng.integers(0, 256, (self.ints(1, 7), 4), dtype=np.uint8)
        cols[:, 3] = 255
        rows, cols_n = self.ints(1, 3), self.ints(1, 4)
        region = (np.arange(h)[:, None] * rows // h) * cols_n + np.arange(w)[None, :] * cols_n // w
        return Image((w, h), cols[region % len(cols)]), True

    def palette(self, k: int):
        return srgb8_to_lab(torch.from_numpy(
            self.rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(self.device))

    def colors(self, k: int) -> np.ndarray:
        c = self.rng.integers(0, 256, (k, 4), dtype=np.uint8)
        c[:, 3] = 255
        return c

    def upload(self, px: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(px)).to(self.device)


# --- Kernels against their twins (tools/soak.py:50-82) ----------------------


def _flips_near_ties(rgb, cents, thr, k_active, mode, row_offset, metric, got, want):
    """`(flipped indices, every flip a near-tie)` of two packed index maps:
    a flip is a near-tie when the twin's distances from the pixel to both
    centroids are within `NEAR_TIE` of each other, relative."""
    h, w = rgb.shape[0], rgb.shape[1]
    kp = cents.shape[0]
    bits, rows = pack_bits(kp), kernels.quant_tile_rows(kp)
    gi = unpack_tile_words(got.cpu().numpy(), h, w, bits, rows).astype(np.int64).reshape(-1)
    wi = unpack_tile_words(want.cpu().numpy(), h, w, bits, rows).astype(np.int64).reshape(-1)
    flips = np.flatnonzero(gi != wi)
    if not len(flips):
        return 0, True
    lab = srgb8_to_lab(rgb).reshape(-1, 3)
    if mode == "dither":
        lab = lab + (thr * bayer_values(h, w, row_offset, rgb.device)).reshape(-1, 1)
    _, dist_sq = metric_fns(metric)
    idx = torch.from_numpy(flips).to(rgb.device)
    dg = dist_sq(lab[idx], cents[torch.from_numpy(gi[flips]).to(rgb.device)])
    dw = dist_sq(lab[idx], cents[torch.from_numpy(wi[flips]).to(rgb.device)])
    return len(flips), bool(((dg - dw).abs() <= NEAR_TIE * torch.maximum(dg, dw)).all())


def _meld_step(got, want, h, w, kp):
    rows = kernels.quant_tile_rows(kp)
    a = unpack_rgb24_tile_words(got.cpu().numpy(), h, w, rows).astype(np.int64)
    b = unpack_rgb24_tile_words(want.cpu().numpy(), h, w, rows).astype(np.int64)
    return np.abs(a - b).max(-1)


def _meld_ok(step, metric, tier) -> bool:
    """`chip_smoke.py::meld_ok`: equal outside exact CIEDE2000, there one
    step on at most 1e-4 of the pixels."""
    if metric == "cie94" or tier != "exact":
        return int(step.max(initial=0)) == 0
    return int(step.max(initial=0)) <= 1 and (step > 0).sum() <= 1e-4 * step.size


def _accum_ok(s: Soak, lab, cents, k_active, metric, fast) -> bool:
    planes, n = kernels.pack_lab_planes(lab)
    inertia = bool(s.rng.random() < 0.5)  # fast CIE94 with it: the algebraic tier
    got = kernels.lloyd_accumulate(planes, cents, n, k_active, None, metric,
                                   emit_inertia=inertia, fast=fast)
    want = kernels.lloyd_accumulate_reference(planes, cents, n, k_active, None, metric,
                                              emit_inertia=inertia, fast=fast)
    err = (got.double() - want.double()).abs()
    scale = want.double().abs() + 128.0 * want[:, 3:4].double()
    return bool(torch.equal(got[:, 3], want[:, 3])) and bool((err <= 1e-5 * scale).all())


def _kernel_trial(s: Soak, h, w, k, ka, mode, metric, fast, row_offset, t) -> None:
    rgb = s.upload(s.noise(h, w)[..., :3])
    cents = s.palette(k)
    what = f"trial={t} {h}x{w} k={k}/{ka} {mode} {metric} fast={fast} row_offset={row_offset}"
    if mode == "meld":
        got = kernels.meld_packed(rgb, cents, ka, metric, fast)
        if s.device.type == "cuda":
            want = kernels.meld_packed_reference(rgb, cents, ka, metric, fast)
            s.check(_meld_ok(_meld_step(got, want, h, w, k), metric,
                             kernels.assign_tier(fast, metric, k)), "meld_packed " + what)
        else:
            out = quantize_image(rgb, cents, "meld", ka, 0, metric)[..., :3].cpu().numpy()
            mine = unpack_rgb24_tile_words(got.numpy(), h, w, kernels.quant_tile_rows(k))
            step = np.abs(mine[..., :3].astype(np.int64) - out.astype(np.int64)).max(-1)
            s.check(step.max(initial=0) <= 1 and (step > 0).mean() <= 1e-3,
                    "meld vs quantize_image " + what)
        return
    thr = dither_threshold(cents, ka, metric) if mode == "dither" else 0.0
    if mode == "dither" and s.device.type == "cuda":
        s.check(torch.equal(thr, dither_threshold_reference(cents, ka, metric)),
                "dither_threshold " + what)
    got = kernels.assign_packed(rgb, cents, thr, ka, mode, row_offset, metric, fast)
    rgba = kernels.quantize_rgba(rgb, cents, thr, ka, mode, row_offset, metric, fast)
    idx = unpack_tile_words(got.cpu().numpy(), h, w, pack_bits(k), kernels.quant_tile_rows(k))
    s.check(int(idx.max(initial=0)) < max(ka, 1), "index range " + what)
    if s.device.type == "cuda":
        want = kernels.assign_packed_reference(rgb, cents, thr, ka, mode, row_offset, metric,
                                               fast)
        flips, near = _flips_near_ties(rgb, cents, thr, ka, mode, row_offset, metric, got,
                                       want)
        s.check(flips == 0 or (metric == "cie2000" and near), f"assign_packed {flips} " + what)
        twin = kernels.quantize_rgba_reference(rgb, cents, thr, ka, mode, row_offset, metric,
                                               fast)
        moved = int((rgba != twin).any(-1).sum())
        s.check(moved <= flips, f"quantize_rgba {moved} px " + what)
        s.check(_accum_ok(s, srgb8_to_lab(rgb).reshape(-1, 3), cents, ka, metric, fast),
                "lloyd_accumulate " + what)
    elif not fast:
        want = quantize_image(rgb, cents, mode, ka, row_offset, metric)
        s.check(torch.equal(rgba, want), "quantize_rgba vs quantize_image " + what)


def _frames_trial(s: Soak, h, w, k, mode, metric, fast, t) -> None:
    b = s.ints(1, 4)
    frames = s.upload(s.noise(b * h, w)[..., :3].reshape(b, h, w, 3))
    cents = torch.stack([s.palette(k) for _ in range(b)])
    kas = [s.ints(1, k + 1) for _ in range(b)]
    what = f"trial={t} frames={b} {h}x{w} k={k} {mode} {metric} fast={fast}"
    if mode == "meld":
        got = kernels.meld_frames_packed(frames, cents, kas, metric, fast)
        want = kernels.meld_frames_packed_reference(frames, cents, kas, metric, fast)
        tier = kernels.assign_tier(fast, metric, k)
        s.check(all(_meld_ok(_meld_step(got[f], want[f], h, w, k), metric, tier)
                    for f in range(b)), "meld_frames_packed " + what)
        return
    thr = (dither_thresholds(cents, kas, metric) if mode == "dither"
           else torch.zeros(b, device=s.device))
    if mode == "dither":
        s.check(torch.equal(thr, dither_thresholds_reference(cents, kas, metric)),
                "dither_thresholds " + what)
    got = kernels.assign_frames_packed(frames, cents, thr, kas, mode, metric, fast)
    want = kernels.assign_frames_packed_reference(frames, cents, thr, kas, mode, metric, fast)
    for f in range(b):
        flips, near = _flips_near_ties(frames[f], cents[f], thr[f], kas[f], mode, 0, metric,
                                       got[f], want[f])
        s.check(flips == 0 or (metric == "cie2000" and near),
                f"assign_frames_packed frame {f} " + what)
    rgba = kernels.quantize_frames(frames, cents, thr, kas, mode, metric, fast)
    twin = kernels.quantize_frames_reference(frames, cents, thr, kas, mode, metric, fast)
    s.check(metric == "cie2000" or torch.equal(rgba, twin), "quantize_frames " + what)


def section_kernels(s: Soak, trials: int) -> None:
    for t in s.rounds(trials):
        h, w = s.ints(1, 120), s.ints(1, 120)
        k = s.ints(1, 14) if t % 3 else s.ints(17, 80)
        ka = s.ints(1, k + 1)
        mode = MODES[t % 3]
        metric = ("cie94", "cie2000")[s.ints(0, 2)]
        fast = k > kernels.FAST_MIN_K and bool(s.ints(0, 2))
        _kernel_trial(s, h, w, k, ka, mode, metric, fast, s.ints(0, 8), t)
        if s.device.type == "cuda":
            _frames_trial(s, max(1, h // 2), max(1, w // 2), k, mode, metric, fast, t)


# --- Host algorithms and codecs (tools/soak.py:84-112) ----------------------


def section_octree(s: Soak, trials: int) -> None:
    for t in s.rounds(trials):
        px = s.rng.integers(0, 256, (400, 3), dtype=np.uint8)
        k = s.ints(1, 12)
        tree = ColorTree()
        for r, g, b in px.tolist():
            tree.add_color(r, g, b)
        s.check(extract_palette_octree(px, k) == tree.reduce(k), f"trial={t} k={k}")


def section_png(s: Soak, trials: int) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for t in s.rounds(trials):
            h, w = s.ints(1, 80), s.ints(1, 80)
            pal = s.colors(s.ints(1, 20))
            img = Image((w, h), pal[s.rng.integers(0, len(pal), (h, w))])
            path = os.path.join(tmp, f"soak_{t}.png")
            imageio.save_image(img, path)
            s.check(np.array_equal(imageio.load_image(path).pixels, img.pixels),
                    f"save/load trial={t} {h}x{w}")
            data = png_py.encode_png(w, h, img.pixels.tobytes())
            s.check(png_py.decode_png(data) == (w, h, img.pixels.tobytes()),
                    f"png_py trial={t} {h}x{w}")


# --- Entry points against each other (tools/soak.py:115-533) ----------------


def section_bucketing(s: Soak, trials: int, exact_p, bucket_p) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(1, 90), s.ints(1, 90), s.ints(1, 9)
        mode = ReduceMode(MODES[t % 3])
        img, _ = s.image(h, w)
        colors = s.colors(k)
        s.check(np.array_equal(exact_p.find(img, colors, mode).pixels,
                               bucket_p.find(img, colors, mode).pixels),
                f"bucketed find trial={t} {h}x{w} k={k} {mode.value}")
        if mode is not ReduceMode.MELD:
            out = bucket_p.reduce(k, img, reduce_mode=mode)
            uniq = len(np.unique(out.pixels.reshape(-1, 4), axis=0))
            s.check(out.dimensions == (w, h) and uniq <= max(k, 1),
                    f"bucketed reduce trial={t} {h}x{w} k={k} uniq={uniq}")


def _palettes_paired_close(pa, pb, tol=3) -> bool:
    """Order-free: every entry of each palette has a distinct partner in the
    other within `tol` u8 steps (tools/soak.py:167)."""
    a, b = pa.astype(int), pb.astype(int)
    if a.shape != b.shape:
        return False
    used = [False] * len(b)
    for row in a:
        d = np.abs(b - row).max(axis=1)
        j = min((jj for jj in range(len(b)) if not used[jj]), key=lambda jj: d[jj])
        if d[j] > tol:
            return False
        used[j] = True
    return True


def section_pipeline(s: Soak, trials: int, exact_p, pipe_p) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(100, 420), s.ints(100, 420), s.ints(1, 9)
        img = Image((w, h), s.noise(h, w))
        sw, sh = shrunk_dimensions(w, h, pipe_p.train_max_size)
        if (sw, sh) != (w, h):
            strip = pipe_p._pipeline_strip(img).pixels[..., :3]
            dev = resize_uint8(s.upload(img.pixels[..., :3]), sh, sw).cpu().numpy()
            s.check(np.abs(strip.astype(int) - dev.astype(int)).max() <= 1,
                    f"strip vs device shrink trial={t} {h}x{w}")
        s.check(_palettes_paired_close(exact_p.palette(k, img), pipe_p.palette(k, img)),
                f"palette trial={t} {h}x{w} k={k}")
        mode = ReduceMode(MODES[t % 2])
        ra = exact_p.reduce(k, img, reduce_mode=mode).pixels.astype(int)
        rb = pipe_p.reduce(k, img, reduce_mode=mode).pixels.astype(int)
        s.check((np.abs(ra - rb).max(-1) > 3).mean() <= 0.01,
                f"reduce trial={t} {h}x{w} k={k} {mode.value}")


def section_gif_batch(s: Soak, trials: int, exact_p, bucket_p) -> None:
    for t in s.rounds(trials):
        h, w, n, k = s.ints(4, 40), s.ints(4, 40), s.ints(1, 12), s.ints(1, 6)
        frames = [s.image(h, w)[0] for _ in range(n)]
        colors = s.colors(k)
        a, b = exact_p.find_batch(frames, colors), bucket_p.find_batch(frames, colors)
        s.check(len(a) == len(b) and all(np.array_equal(x.pixels, y.pixels)
                                         for x, y in zip(a, b)),
                f"bucketed find_batch trial={t} {n}x{h}x{w}")
        outs = bucket_p.reduce_images(frames, k)
        s.check(len(outs) == n and all(
            o.dimensions == (w, h) and len(np.unique(o.pixels.reshape(-1, 4), axis=0)) <= k
            for o in outs), f"bucketed reduce_images trial={t}")
        pal = bucket_p.palette_images(frames, k)
        s.check(1 <= pal.shape[0] <= k, f"bucketed palette_images trial={t}")


def section_delta_e_2000(s: Soak, trials: int, de_p) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(4, 70), s.ints(4, 70), s.ints(1, 8)
        mode = ReduceMode(MODES[t % 3])
        img, _ = s.image(h, w)
        out = de_p.reduce(k, img, reduce_mode=mode)
        uniq = len(np.unique(out.pixels.reshape(-1, 4), axis=0))
        s.check(out.dimensions == (w, h) and (mode is ReduceMode.MELD or uniq <= k),
                f"reduce trial={t} {h}x{w} k={k} uniq={uniq}")
        s.check(de_p.find(img, s.colors(k), mode).dimensions == (w, h), f"find trial={t}")


def _rgba_of(s: Soak, h: int, w: int, k: int, ka: int, metric: str, mode: str):
    rgb = s.upload(s.noise(h, w)[..., :3])
    pal = s.palette(k)
    thr = dither_threshold(pal, ka, metric) if mode == "dither" else 0.0
    return rgb, pal, thr


def section_fast_mode(s: Soak, trials: int) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(4, 60), s.ints(4, 60), s.ints(17, 48)
        ka, mode = s.ints(1, k + 1), MODES[t % 2]
        rgb, pal, thr = _rgba_of(s, h, w, k, ka, "cie94", mode)
        exact = kernels.quantize_rgba(rgb, pal, thr, ka, mode, 0, "cie94", False)
        fast = kernels.quantize_rgba(rgb, pal, thr, ka, mode, 0, "cie94", True)
        flips = float((exact != fast).any(-1).float().mean())
        s.check(flips <= 1e-3, f"flips {flips:.2%} trial={t} k={k}/{ka}")


def section_fused_cie2000(s: Soak, trials: int) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(2, 60), s.ints(2, 60), s.ints(1, 10)
        ka, mode = s.ints(1, k + 1), MODES[t % 2]
        rgb, pal, thr = _rgba_of(s, h, w, k, ka, "cie2000", mode)
        got = kernels.assign_packed(rgb, pal, thr, ka, mode, 0, "cie2000")
        want = kernels.assign_packed_reference(rgb, pal, thr, ka, mode, 0, "cie2000")
        flips, near = _flips_near_ties(rgb, pal, thr, ka, mode, 0, "cie2000", got, want)
        s.check(near, f"{flips} flips not all near-ties trial={t} {h}x{w} k={k}/{ka} {mode}")
        rgba = kernels.quantize_rgba(rgb, pal, thr, ka, mode, 0, "cie2000")
        plain = quantize_image(rgb, pal, mode, ka, 0, "cie2000")
        moved = float((rgba != plain).any(-1).float().mean())
        s.check(moved <= 2e-3, f"vs quantize_image {moved:.2%} trial={t}")


def section_streamed(s: Soak, trials: int, bucket_p) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(6, 60), s.ints(6, 60), s.ints(1, 6)
        mode = ReduceMode(MODES[t % 3])
        band = s.ints(4, max(5, h))
        img, _ = s.image(h, w)
        a = bucket_p.reduce(k, img, reduce_mode=mode)
        b = bucket_p.reduce_streamed(k, img, reduce_mode=mode, band_rows=band)
        s.check(np.array_equal(a.pixels, b.pixels),
                f"trial={t} {h}x{w} k={k} {mode.value} band={band}")


def _batch_images(s: Soak, lo=18, hi=40) -> tuple:
    imgs = [s.image(s.ints(lo, hi), s.ints(lo, hi)) for _ in range(s.ints(2, 5))]
    return [i for i, _ in imgs], [f for _, f in imgs]


def _matches_solo(s: Soak, outs, solos, flats, what: str) -> None:
    """Each output against its solo call: the same pixels on 99.9% (all of
    them where an image holds exact ties)."""
    for i, (out, solo, flat) in enumerate(zip(outs, solos, flats)):
        frac = float((out.pixels == solo.pixels).all(-1).mean())
        s.check(frac >= (1.0 if flat else 0.999), f"{what} image {i} frac={frac:.5f}")


def _same(a, b) -> bool:
    return all(np.array_equal(getattr(x, "pixels", x), getattr(y, "pixels", y))
               for x, y in zip(a, b))


# The coalescers' vmapped trainers seed on stored Lab, where a solo call
# fuses the conversion into its first map (C.7): at exact ties the JAX
# package's own `palette_many` and `palette` differ. So an image of flat
# regions is held, with no tolerance, to the same batch in reverse order
# (members are independent); a noise image to its solo call.


def section_micro_batch(s: Soak, trials: int, bucket_p) -> None:
    for t in s.rounds(trials):
        k, mode = s.ints(2, 6), ReduceMode(MODES[t % 2])
        imgs, flats = _batch_images(s)
        outs = bucket_p.reduce_many(imgs, k, mode)
        s.check(_same(outs, bucket_p.reduce_many(imgs[::-1], k, mode)[::-1]),
                f"reduce_many reversed trial={t} k={k} {mode.value}")
        noise = [i for i, f in enumerate(flats) if not f]
        _matches_solo(s, [outs[i] for i in noise],
                      [bucket_p.reduce(k, imgs[i], reduce_mode=mode) for i in noise],
                      [False] * len(noise), f"reduce_many trial={t} k={k} {mode.value}")
        colors = s.colors(s.ints(1, 7))
        outs = bucket_p.find_many(imgs, colors, mode)
        s.check(all(np.array_equal(o.pixels, bucket_p.find(im, colors, mode).pixels)
                    for o, im in zip(outs, imgs)), f"find_many trial={t}")


def section_palette_many(s: Soak, trials: int, bucket_p) -> None:
    for t in s.rounds(trials):
        k = s.ints(1, 7)
        imgs, flats = _batch_images(s)
        pals = bucket_p.palette_many(imgs, k)
        s.check(_same(pals, bucket_p.palette_many(imgs[::-1], k)[::-1]), f"reversed trial={t}")
        s.check(all(np.array_equal(p, bucket_p.palette(k, im))
                    for p, im, f in zip(pals, imgs, flats) if not f), f"trial={t} k={k}")


def section_pruned_cie2000(s: Soak, trials: int) -> None:
    for t in s.rounds(trials):
        h, w, k = s.ints(8, 60), s.ints(8, 60), s.ints(17, 48)
        ka = s.ints(max(1, k - 8), k + 1)
        rgb, pal, thr = _rgba_of(s, h, w, k, ka, "cie2000", "replace")
        exact = kernels.quantize_rgba(rgb, pal, thr, ka, "replace", 0, "cie2000", False)
        pruned = kernels.quantize_rgba(rgb, pal, thr, ka, "replace", 0, "cie2000", True)
        flips = float((exact != pruned).any(-1).float().mean())
        lab = srgb8_to_lab(rgb).reshape(-1, 3)
        opt = distance_cie2000(lab[:, None, :], pal[None, :ka, :]).min(dim=1).values
        chosen = distance_cie2000(lab, srgb8_to_lab(pruned[..., :3]).reshape(-1, 3))
        excess = float((chosen - opt).mean())
        s.check(flips <= 4e-2 and excess <= 0.15,
                f"flips {flips:.2%} mean excess {excess:.3f} dE trial={t} k={k}/{ka}")


def section_heavy_bucket(s: Soak, trials: int, bucket_p) -> None:
    """`reduce_many` / `palette_many` on `_plain_fit_route`'s false branch,
    forced as the reference's soak forces it (k > 64, the element budget
    at 1), against solo calls."""
    budget = api_mod._CHUNKED_TRAIN_ELEMS
    api_mod._CHUNKED_TRAIN_ELEMS = 1
    try:
        for t in s.rounds(trials):
            mode = ReduceMode(MODES[t % 2])
            imgs, flats = _batch_images(s, 6, 14)  # k = 65 trains for long on the CPU
            _matches_solo(s, bucket_p.reduce_many(imgs, 65, mode),
                          [bucket_p.reduce(65, im, reduce_mode=mode) for im in imgs], flats,
                          f"reduce_many trial={t} {mode.value}")
            pals = bucket_p.palette_many(imgs, 65)
            s.check(all(np.array_equal(p, bucket_p.palette(65, im))
                        for p, im in zip(pals, imgs)), f"palette_many trial={t}")
    finally:
        api_mod._CHUNKED_TRAIN_ELEMS = budget


def section_colour_out(s: Soak, trials: int) -> None:
    """The closed two-half kernel's section: the colour-out mode at random
    `k_active` across 1024 (`INDEXED_MAX_K`) against its twin, or on the
    CPU against `quantize_image`."""
    k, h, w = 1030, 14, 22
    for t in s.rounds(trials):
        ka = int(s.rng.choice([k, 1025, 1024 + s.ints(1, k - 1023), s.ints(1, 1024)]))
        mode = MODES[t % 2]
        rgb, pal, thr = _rgba_of(s, h, w, k, ka, "cie94", mode)
        got = kernels.quantize_rgba(rgb, pal, thr, ka, mode)
        want = (kernels.quantize_rgba_reference(rgb, pal, thr, ka, mode)
                if s.device.type == "cuda" else quantize_image(rgb, pal, mode, ka))
        s.check(torch.equal(got, want), f"trial={t} k={k}/{ka} {mode}")


def section_sharded_batch(s: Soak, trials: int, plain_p) -> None:
    """The sharded batch entry points on a mesh of two repeats of the one
    device against their per-image forms: bit-equal `find`, trainings
    within 2 u8 (tools/soak.py:572-640). Flat frames (exact ties) take no
    tolerance: `reduce_images_sharded` against `reduce_sharded`, and
    `palette_images_sharded` against itself on one shard (the sharded
    trainers seed on stored Lab, `palette_images` fuses the conversion)."""
    mesh, one = make_mesh([s.device] * 2, data=1), make_mesh([s.device], data=1)
    h, w, n, k = 24, 30, 2, 4
    for t in s.rounds(trials):
        flat = bool(s.rng.random() < 1 / 3)
        frames = [s.image(h, w, flat)[0] for _ in range(n)]
        mode = ReduceMode(MODES[t % 2])
        outs = plain_p.reduce_images_sharded(frames, k, mode, mesh=mesh)
        for i, (im, out) in enumerate(zip(frames, outs)):
            ref = plain_p.reduce_sharded(k, im, mode, mesh=mesh)
            diff = np.abs(out.pixels.astype(int) - ref.pixels.astype(int)).max()
            s.check(diff <= (0 if flat else 2),
                    f"reduce_images_sharded frame {i} trial={t} step={diff}")
        pal_j = plain_p.palette_images_sharded(frames, k, mesh=mesh)
        pal_s = (plain_p.palette_images_sharded(frames, k, mesh=one) if flat
                 else plain_p.palette_images(frames, k))
        s.check(pal_j.shape == pal_s.shape
                and np.abs(pal_j.astype(int) - pal_s.astype(int)).max() <= (0 if flat else 2),
                f"palette_images_sharded trial={t} flat={flat}")
        colors = s.colors(3)
        fouts = plain_p.find_batch_sharded(frames, colors, mode, mesh=mesh)
        s.check(all(np.array_equal(o.pixels, plain_p.find_sharded(im, colors, mode,
                                                                   mesh=mesh).pixels)
                    for o, im in zip(fouts, frames)), f"find_batch_sharded trial={t}")


# The reference soak's sections in its order, with its lines, and each
# one's trial count at `trials` (the reference's ratios).
SECTIONS = (
    ("kernels", "tools/soak.py:50-82", lambda n: n),
    ("octree", "tools/soak.py:84-97", lambda n: 10),
    ("png", "tools/soak.py:99-112", lambda n: 20),
    ("bucketing", "tools/soak.py:115-144", lambda n: max(10, n // 4)),
    ("pipeline", "tools/soak.py:146-227", lambda n: max(6, n // 8)),
    ("gif-batch", "tools/soak.py:229-260", lambda n: max(5, n // 10)),
    ("delta-e-2000", "tools/soak.py:262-287", lambda n: max(5, n // 10)),
    ("fast-mode", "tools/soak.py:289-312", lambda n: max(5, n // 10)),
    ("fused-cie2000", "tools/soak.py:314-342", lambda n: max(5, n // 12)),
    ("streamed", "tools/soak.py:343-359", lambda n: max(5, n // 12)),
    ("micro-batch", "tools/soak.py:360-420", lambda n: max(4, n // 15)),
    ("palette-many", "tools/soak.py:420-440", lambda n: max(4, n // 15)),
    ("pruned-cie2000", "tools/soak.py:440-495", lambda n: max(5, n // 12)),
    ("heavy-bucket", "tools/soak.py:495-533", lambda n: max(3, n // 20)),
    ("colour-out", "tools/soak.py:533-572", lambda n: max(3, n // 15)),
    ("sharded-batch", "tools/soak.py:572-640", lambda n: max(2, n // 15)),
)


def run(trials: int = 60, seed: int = 1234, budget: float = 600.0, device: str = "cuda",
        only=None) -> dict:
    """Run the sections (or those named in `only`) with `budget` seconds
    split evenly among them. Returns the summary: trials, failures and
    kernel launches by section (by `"wrapper metric tier"`, as
    `ops/kernels.py::LAUNCHES_BY_MODE` keys them), the failure messages,
    seconds."""
    s = Soak(device, seed)
    exact_p = ImageProcessor(device=device)
    bucket_p = ImageProcessor(device=device, bucketing=True)
    procs = {
        "bucketing": (exact_p, bucket_p), "pipeline": (exact_p, ImageProcessor(
            device=device, pipeline=True)), "gif-batch": (exact_p, bucket_p),
        "delta-e-2000": (ImageProcessor(device=device, delta_e="2000"),),
        "streamed": (bucket_p,), "micro-batch": (bucket_p,), "palette-many": (bucket_p,),
        "heavy-bucket": (bucket_p,), "sharded-batch": (exact_p,),
    }
    chosen = [sec for sec in SECTIONS if only is None or sec[0] in only]
    share = budget / max(len(chosen), 1)
    t0 = time.monotonic()
    for i, (name, _, count) in enumerate(SECTIONS):
        if only is not None and name not in only:
            continue
        # Each section draws from its own stream: what it draws does not
        # depend on how many trials the budget left to the ones before it.
        s.rng = np.random.default_rng([seed, i])
        s.section, s.deadline = name, time.monotonic() + share
        fn = globals()["section_" + name.replace("-", "_")]
        before = collections.Counter(kernels.LAUNCHES_BY_MODE)
        try:
            fn(s, count(trials), *procs.get(name, ()))
        except Exception as exc:  # a crash is a failure of its section
            s.check(False, f"raised {type(exc).__name__}: {exc}")
        after = collections.Counter(kernels.LAUNCHES_BY_MODE)
        added = collections.Counter()
        for key, n in (after - before).items():
            added[" ".join(key)] += n
        s.launches[name] = dict(added)
    return {
        "trials": dict(s.trials), "failures": {name: s.failures[name] for name, _, _ in chosen},
        "launches": s.launches, "messages": s.messages,
        "seconds": time.monotonic() - t0, "device": str(s.device),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Randomized equivalence soak of the port.")
    parser.add_argument("trials", nargs="?", type=int, default=60)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--budget", type=float, default=600.0,
                        help="wall-clock seconds, shared evenly by the sections")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    parser.add_argument("--sections", default=None, help="comma-separated section names")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    only = None if args.sections is None else set(args.sections.split(","))
    out = run(args.trials, args.seed, args.budget, "cpu" if args.cpu else "cuda", only)
    failed = sum(out["failures"].values())
    print("SOAK " + json.dumps({k: out[k] for k in ("trials", "failures", "launches",
                                                   "seconds", "device")}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
