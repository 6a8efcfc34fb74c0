#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and the CUDA toolkit (`nvcc`); it builds the port's kernels
from `kmeans_tpu_torch/csrc/` and the experiment tools' kernels from
`kmeans_tpu_torch/tools/csrc/` (two libraries, built side by side) and
then:

1. device: prints the card (`nvidia-smi` name and power limit), torch and
   CUDA versions;
2. build: compiles both libraries and prints the seconds it took; beside
   them compiles the assign and accumulator sources with `-Xptxas -v` and
   prints a `ptxas` line for each kernel instance (registers, stack and
   spill bytes: a spill in an exact assign or an accumulator instance
   fails) and a `sass` line for
   each exact instance's centroid loop in the built library (its
   instructions, per pixel-centroid pair, by opcode);
3. kernel vs plain: holds `assign_packed` (the CUDA kernel) against
   `assign_packed_reference` (plain PyTorch) on the same CUDA tensors,
   over palette sizes, both modes, ragged shapes, `k_active < kp`,
   `row_offset=3` and one 2160x3840 image; under CIE94 the words must be
   equal, under CIEDE2000 every flipped index must be a near-tie (the
   plain version's two distances within 1e-5). Then `meld_packed` against
   `meld_packed_reference` over k = 1..1025, both metrics, ragged shapes
   and a palette with a repeated colour: CIE94 equal words, CIEDE2000
   within 1 u8 step on at most 1e-4 of the pixels. Then
   `lloyd_accumulate` (the CUDA kernel) against
   `lloyd_accumulate_reference` over k = 1..512, both metrics, ragged
   pixel counts, `k_active < kp`, a weight plane, the inertia column,
   bfloat16 planes and one 3840x2160 image: counts equal, the other
   columns within `1e-5 * (|plain| + 128 * count)`, and two launches give
   equal totals. Then `exact_tile_vs_plain`: the register-tiled exact
   kernels (every assign output mode, and the accumulator) on adversarial
   palettes (duplicate centroids, grey pixels, centroids equal to pixels,
   a centroid at +-inf, a chroma of 1e-25, `k_active < kp`) at k = 1..512,
   both metrics: equal words, equal counts;
4. the slice: drives `ImageProcessor(device="cuda")` through `reduce`
   (replace and dither), `palette` and `find` on a seeded synthetic
   3840x2160 image, checks the outputs, checks that each reduce equals
   the plain version's indices for the trained palette, checks that the
   assign kernel was launched by those calls, and holds a small reduce on
   the card against the same reduce on the CPU. Then the full-resolution
   slice, `ImageProcessor(device="cuda", train_max_size=None)`: a k=8
   reduce and palette, a k=256 palette and a k=8 palette with
   `restarts=2` on the same image, each checked against the accumulator
   launches its iterations need; and a full-resolution palette and
   reduce of a 1200x1000 image on the card against the CPU. Then the
   meld slice (a k=8 meld reduce and a 16-colour meld find), the
   CIEDE2000 slice (`delta_e="2000"`: replace, dither and meld reduces, a
   palette and a meld find) and the full-resolution CIEDE2000 reduce,
   each with its launch counts, its outputs against the plain versions
   on the same palette, and a 300x420 reduce on the card against the CPU.
   Then the fast slice (`fast=True`, which acts at 16 < k <= 512): the
   factorized-CIE94 and pruned-CIEDE2000 tiers of the three kernels
   against their plain versions (k = 17..513, `k_active` below the
   candidate count, ragged shapes and 4K: equal words, equal counts);
   4K `reduce(64)` in three modes under CIE94 and two under
   `delta_e="2000"`, `find` with 256 colours under both, the
   full-resolution `reduce(64)` with `restarts=2` and `palette(256)`
   under `delta_e="2000"`, each with its launches by kernel mode and its
   output against the plain version's; `fast_vs_exact`, the share of
   pixels (or of per-cluster counts) each fast mode moves against the
   exact kernel on the same palette; and a 150x210 k=24 reduce on the
   card against the CPU. Then frame batching and palettes past 1024
   colours: `frames_kernel_vs_plain` (the frames modes of the assign and
   meld kernels: packed, meld, RGBA; B = 1, 3, 8; k = 1..1024; per-frame
   `k_active` and thresholds; one image through B palettes; both metrics;
   the fast tiers at k = 64), `colour_out_vs_plain` (`quantize_rgba` at
   k = 1..16384, `assign_u8`, the meld kernel at k = 16384: one chunk of
   staged centroids and several), the slice on 16 frames of 1920x1080 and
   the 4K image (`reduce_images`, `find_batch`, `palette_images`,
   `reduce_batch`, `reduce(2048)`, `find` with 2048 and 16384 colours),
   each path with exactly its one launch (and, under dither, one launch
   of the threshold kernel) and its output against the plain version's,
   and a small batch on the card against the CPU. Then this slice:
   `tf32_training` (`reduce`, `reduce_images` and the row-chunked
   full-resolution trainer at k = 600 give equal outputs with TF32 on
   through either torch API, and the caller's flags read back unchanged),
   `frames_past_grid_limit` (65,537 frames of 4x4 through both frames
   kernels: equal to split launches and to the twins),
   `dither_threshold_vs_plain` (the threshold kernel's bits against the
   twin's at k = 1..2048, both metrics, one and three palettes; times
   against the plain loop; `reduce(2048)` dither against replace), and
   the experiment tools through their entry points:
   `exp_mxu_vs_plain` (`kmeans_tpu_torch.tools.exp_mxu`: factor-vpu
   against its twin and the fast u8 assign, factor-mxu against its TF32
   twin with each flip a near-tie, `mismatch_frac_vs_exact`, times beside
   `argmin(feats @ G)` with TF32 off and on) and `exp_gather_vs_plain`
   (`kmeans_tpu_torch.tools.exp_gather`: each table placement returns the
   table's bits, the lut sums equal their twin, the pow sums their twin's
   bits or counted ulps, times beside `torch.take`);
5. times: the median of 5 warm 4K k=8 reduces with their phases (shrunk
   and full-resolution CIE94 replace, meld, CIEDE2000 replace, in turns),
   and each kernel alone against its plain version alone (CUDA events),
   beside its bound; the fast modes at k = 64 and k = 256 in turns with
   the exact kernel at the same k; the new kernel modes at the slice's
   shapes; one frames launch against 16 single-frame launches, and
   `reduce_images` against 16 `reduce` calls end to end, in turns; the
   shrunk training at k = 8 and 2048 with the float64 one-hot product
   against the float32 one, in turns.

Every phase prints one JSON line. The script exits non-zero on any
failure, and when no CUDA device is present. Its last three lines are the
kernels' summary (`launches` counts the launches of the driven paths;
`launched_by` says whether they came through `ImageProcessor`, an
experiment tool's evaluation pass or, for the forms no entry point
reaches, a direct call of the wrapper), the card's
`nvidia-smi` line, and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
HEIGHT, WIDTH = 2160, 3840
K = 8
COMPARE_KS = (1, 2, 4, 8, 16, 17, 256, 257, 512, 1024)
COMPARE_KS_2000 = (1, 8, 17, 257)
FAST_KS = (17, 64, 129, 256, 512, 513)  # 513 falls back to the exact loop
FAST_K, FAST_K_LARGE = 64, 256  # the fast slice's palette sizes (m = 8, m = 16)
MELD_KS = (1, 2, 8, 17, 256, 1025)
RAGGED = ((61, 97), (257, 129), (8, 8))
ACCUM_KS = (1, 2, 8, 17, 64, 65, 256, 512)
ACCUM_PIXELS = 100_003  # ragged: not a multiple of the 16384-pixel granule
# Published peaks of one H100 SXM at 700 W (the rates a bound is taken at).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations of one pixel-centroid distance and its argmin update,
# as `csrc/delta_e.cuh` spells them, each library call (sqrt, divide,
# atan2f, sinf, cosf, expf) counted as one: CIE94 16 + 2; CIEDE2000 104
# (9 of them atan2f, sinf, cosf and expf calls) + 1.
METRIC_OPS = {"cie94": 18, "cie2000": 105}
# The fast tiers, as `csrc/screen.cuh` spells them. The factorized score is
# 12 operations (6 multiplies, 6 adds) and its compare: 13 a centroid; the
# accumulator's algebraic distance 13 (4 subtractions, 6 multiplies, 3
# adds) and its compare: 14. Their pixel side is 20 operations (chroma 4;
# `screen_factors` 16: S_C 2, S_H 2, rsh2 2, q 3, f0 1, f2, f4, f5 2 each)
# where the exact forms have 9. The pruned tier needs at least
# the score and one compare against the list for every centroid (13), and
# for each of its min(m, k_active) survivors one walk into the list (2 m
# selects) and one exact CIEDE2000 distance (105). The reference's
# insertion network runs its 2 m selects for every centroid; the kernel
# skips the walk when the score is not below the list's last, so the bound
# counts only the walks that the result needs.
SCREEN_OPS = 13
ALGEBRAIC_OPS = 14
PIXEL_OPS = {"exact": 9, "factor": 20, "algebraic": 20, "prune": 20}


def centroid_ops(metric: str, tier: str, kp: int, k_active: int) -> int:
    """Float32 operations of one pixel's pass over the centroids."""
    if tier == "exact":
        return METRIC_OPS[metric] * k_active
    if tier == "factor":
        return SCREEN_OPS * k_active
    if tier == "algebraic":
        return ALGEBRAIC_OPS * k_active
    from kmeans_tpu_torch.ops import kernels

    m = min(kernels.prune_m_for(kp), kp)
    return SCREEN_OPS * k_active + min(m, k_active) * (2 * m + METRIC_OPS["cie2000"])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def synthetic_image(height: int, width: int, seed: int = SEED) -> np.ndarray:
    """Gradient plus uniform noise in [-8, 8], RGBA with alpha 255: the
    synthetic frame the JAX package's benchmark uses."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    rgb = np.stack(
        [x * 255 // width, y * 255 // height, (x + y) * 255 // (width + height)],
        axis=-1,
    ).astype(np.uint8)
    noise = rng.integers(-8, 9, rgb.shape)
    rgb = np.clip(rgb.astype(int) + noise, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((height, width, 1), 255, np.uint8)], axis=-1)


def random_palette_lab(k: int, seed: int, device):
    """`k` Lab centroids made from seeded random sRGB colours."""
    import torch

    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(device)
    return srgb8_to_lab(rgb).contiguous()


def compare_case(h, w, k, mode, device, k_active=None, row_offset=0, seed=1,
                 metric="cie94", fast=False):
    """Kernel vs plain on one case: (mismatched words, max |index diff|,
    flipped indices, whether every flip is a near-tie: the plain version's
    distances from the pixel to the two centroids within 1e-5 of each
    other, relative)."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.delta_e import metric_fns
    from kmeans_tpu_torch.ops.quantize import bayer_values, dither_threshold
    from kmeans_tpu_torch.utils.packing import pack_bits, unpack_tile_words

    rng = np.random.default_rng(seed + 7919 * k + h)
    rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    cents = random_palette_lab(k, seed + k, device)
    thr = dither_threshold(cents, k_active, metric) if mode == "dither" else 0.0
    got = kernels.assign_packed(rgb, cents, thr, k_active, mode, row_offset, metric, fast)
    want = kernels.assign_packed_reference(rgb, cents, thr, k_active, mode, row_offset, metric,
                                           fast)
    torch.cuda.synchronize()
    mismatched = int((got != want).sum().item())
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    gi = unpack_tile_words(got.cpu().numpy(), h, w, bits, rows).astype(np.int64).reshape(-1)
    wi = unpack_tile_words(want.cpu().numpy(), h, w, bits, rows).astype(np.int64).reshape(-1)
    flips = np.flatnonzero(gi != wi)
    near_ties = True
    if len(flips):
        lab = srgb8_to_lab(rgb).reshape(-1, 3)
        if mode == "dither":
            lab = lab + (thr * bayer_values(h, w, row_offset, device)).reshape(-1, 1)
        _, dist_sq = metric_fns(metric)
        idx = torch.from_numpy(flips).to(device)
        dg = dist_sq(lab[idx], cents[torch.from_numpy(gi[flips]).to(device)])
        dw = dist_sq(lab[idx], cents[torch.from_numpy(wi[flips]).to(device)])
        near_ties = bool(((dg - dw).abs() <= 1e-5 * torch.maximum(dg, dw)).all())
    return mismatched, int(np.abs(gi - wi).max()), len(flips), near_ties


def meld_case(h, w, k, metric, device, repeat=False, seed=5, k_active=None, fast=False):
    """Meld kernel vs plain on one case; `repeat` makes the last colour a
    copy of the first. Returns the case's JSON line: differing words, and
    the pixels that differ and their largest channel step once unpacked."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.utils.packing import unpack_rgb24_tile_words

    rng = np.random.default_rng(seed + 7919 * k + h)
    rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    cents = random_palette_lab(k, seed + k, device)
    if repeat:
        cents[-1] = cents[0]
    got = kernels.meld_packed(rgb, cents, k_active, metric, fast)
    want = kernels.meld_packed_reference(rgb, cents, k_active, metric, fast)
    torch.cuda.synchronize()
    rows = kernels.quant_tile_rows(k)
    a = unpack_rgb24_tile_words(got.cpu().numpy(), h, w, rows).astype(np.int64)
    b = unpack_rgb24_tile_words(want.cpu().numpy(), h, w, rows).astype(np.int64)
    step = np.abs(a - b).max(-1)
    return {
        "phase": "fast_meld_kernel_vs_plain" if fast else "meld_kernel_vs_plain",
        "h": h, "w": w, "k": k, "k_active": k_active, "metric": metric,
        "tier": kernels.assign_tier(fast, metric, k), "repeated_colour": repeat,
        "mismatched_words": int((got != want).sum().item()),
        "differing_pixels": int((step > 0).sum()), "max_channel_step": int(step.max()),
        "pixels": h * w,
    }


def meld_ok(line) -> bool:
    """CIE94: equal words. CIEDE2000: within 1 u8 step on at most 1e-4 of
    the pixels."""
    if line["metric"] == "cie94":
        return line["mismatched_words"] == 0
    return line["max_channel_step"] <= 1 and line["differing_pixels"] <= 1e-4 * line["pixels"]


def random_lab(n: int, seed: int, device):
    """`[n, 3]` Lab of seeded random sRGB pixels."""
    import torch

    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    rng = np.random.default_rng(seed)
    return srgb8_to_lab(torch.from_numpy(rng.integers(0, 256, (n, 3), dtype=np.uint8)).to(device))


def accum_case(lab, k, device, k_active=None, weighted=False, inertia=False,
               bf16=False, seed=3, metric="cie94", fast=False):
    """Accumulator kernel vs plain on one case. Counts must be equal, the
    other columns within 1e-5 * (|plain| + 128 * count) (`max_err_over_scale`
    <= 1e-5), and a second launch must give the same totals. Returns the
    case's JSON line."""
    import torch

    from kmeans_tpu_torch.ops import kernels

    planes, n = kernels.pack_lab_planes(lab, torch.bfloat16 if bf16 else None)
    cents = random_palette_lab(k, seed + k, device)
    w = None
    if weighted:  # integer weights, 0 included: their sums stay exact
        rng = np.random.default_rng(seed + 1)
        w = kernels.pack_plane(torch.from_numpy(
            rng.integers(0, 4, n).astype(np.float32)).to(device))
    args = (planes, cents, n, k_active, w, metric)
    got = kernels.lloyd_accumulate(*args, emit_inertia=inertia, fast=fast)
    again = kernels.lloyd_accumulate(*args, emit_inertia=inertia, fast=fast)
    want = kernels.lloyd_accumulate_reference(*args, emit_inertia=inertia, fast=fast)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    scale = want.double().abs() + 128.0 * want[:, 3:4].double()
    # 0 / 0 (an empty cluster) is no error; any error where the scale is 0 fails.
    ratio = torch.where(scale > 0, err / scale.clamp(min=1e-300), err * float("inf"))
    return {
        "phase": "fast_lloyd_kernel_vs_plain" if fast else "lloyd_kernel_vs_plain",
        "pixels": n, "k": k, "k_active": k_active, "metric": metric,
        "tier": kernels.accum_tier(fast, metric, k, inertia),
        "weighted": weighted, "emit_inertia": inertia, "bf16": bf16,
        "counts_equal": bool(torch.equal(got[:, 3], want[:, 3])),
        "max_abs_err": float(err.max()),
        "max_err_over_scale": float(torch.nan_to_num(ratio, nan=0.0).max()),
        "deterministic": bool(torch.equal(got, again)),
        "total_count": float(want[:, 3].sum()),
    }


def _table_bytes(kp, tier):
    """The centroids read once, and the `[kp, 7]` feature table of the
    factorized and pruned tiers."""
    return kp * 12 + (kp * 28 if tier in ("factor", "prune") else 0)


def accum_bound(n_pix, n_valid, kp, k_active, stats, bf16=False, weighted=False,
                metric="cie94", tier="exact"):
    """The least time (ms) the card could take for one accumulator call,
    and what bounds it. Bytes: the planes (and weights) read once, the
    centroids (and the fast tiers' table) read and the totals written
    once. Float32 operations, as `csrc/lloyd_accumulate.cu` spells them,
    for each valid pixel: `PIXEL_OPS` pixel-side, `centroid_ops` over the
    centroids, 2 per output column."""
    bytes_moved = (n_pix * (3 * (2 if bf16 else 4) + (4 if weighted else 0))
                   + _table_bytes(kp, tier) + kp * stats * 4)
    ops = n_valid * (PIXEL_OPS[tier] + centroid_ops(metric, tier, kp, k_active) + 2 * stats)
    return _bound(bytes_moved, ops)


def assign_bound(n, n_pad, n_words, kp, k_active, metric="cie94", tier="exact",
                 out_bytes=4, palette_words=False):
    """The least time (ms) the card could take for one replace-mode
    assign call, and what bounds it. `k_active` is an int, or a list of
    one per frame for a frames launch (each frame `n` pixels, `n_words`
    outputs). Bytes: each frame's RGB read once, its outputs of
    `out_bytes` each written once (packed and RGBA words 4, u8 indices 1),
    the gamma table and its centroids (and, for RGBA, its palette's words)
    read once. Float32 operations, as `csrc/quantize_assign.cu` spells
    them, for each of the `n_pad` pixels it computes: 18 for RGB -> XYZ,
    9 for the three Lab f-functions (each `powf` counted as one), 6 for L,
    a, b, `PIXEL_OPS` pixel-side terms and `centroid_ops` over the
    centroids."""
    k_actives = k_active if isinstance(k_active, list) else [k_active]
    bytes_moved = 256 * 4 + len(k_actives) * (
        3 * n + out_bytes * n_words + _table_bytes(kp, tier) + (4 * kp if palette_words else 0))
    ops = n_pad * sum(33 + PIXEL_OPS[tier] + centroid_ops(metric, tier, kp, ka)
                      for ka in k_actives)
    return _bound(bytes_moved, ops)


def meld_bound(n, n_pad, kp, k_active, metric, tier="exact"):
    """The least time (ms) the card could take for one meld call, and what
    bounds it; `k_active` as in `assign_bound`. Bytes: each frame's RGB
    read once, its 3 B/px of words written once, the gamma table and its
    centroids read once. Float32 operations, as `csrc/quantize_meld.cu`
    spells them, for each of the `n_pad` pixels: 33 into Lab and
    `PIXEL_OPS` pixel terms (as `assign_bound`), `centroid_ops` over the
    centroids, one more distance and 4 weights for d(closest, second)
    (and, under the factorized tier, one more exact distance for the
    numerator), 4 for the factor, 9 for the blend, 53 back to u8 sRGB
    (three `powf` counted as one each)."""
    k_actives = k_active if isinstance(k_active, list) else [k_active]
    bytes_moved = 256 * 4 + len(k_actives) * (3 * n + 3 * n_pad + _table_bytes(kp, tier))
    m = METRIC_OPS[metric]
    extra = m if tier == "factor" else 0
    ops = n_pad * sum(33 + PIXEL_OPS[tier] + centroid_ops(metric, tier, kp, ka)
                      + m + extra + 4 + 4 + 9 + 53 for ka in k_actives)
    return _bound(bytes_moved, ops)


def _bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Mean milliseconds per call of `fn` on the current stream, after one
    warm-up call, by CUDA events. With `flush` (a tensor larger than the
    L2 cache), it is overwritten before each call, outside the timed span,
    so each call starts with a cold cache."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def profile_call(call, card: str, what: str) -> dict:
    """One warm `call()` under torch.profiler: the device's busy time (the
    union of the intervals of every event on the card: kernels and copies),
    its share of the wall time, and the costliest device events by name.
    The profiler's own host overhead lengthens the wall time, so the idle
    share it gives is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device_events):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    by_name: dict = {}
    for e in device_events:
        t, c = by_name.get(e.name[:80], (0.0, 0))
        by_name[e.name[:80]] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    measured = bool(device_events)
    return {
        "phase": "timing", "what": f"profile of one {what}",
        "card": card, "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if measured else "not measured",
        "device_idle_share": 1 - busy_us / 1e3 / wall_ms if measured else "not measured",
        "device_events": len(device_events),
        "top_device_events": [{"name": n, "ms": t, "count": c} for n, (t, c) in top],
    }


def unique_rgba(pixels: np.ndarray) -> np.ndarray:
    return np.unique(np.ascontiguousarray(pixels).view(np.uint32))


def timed_reduces(procs: dict, image, card: str, k: int = K, rounds: int = 6) -> list:
    """For each `what -> (processor, mode)`, the median of `rounds - 1`
    warm `reduce(k, image, KMEANS, mode)` calls (after one more) with
    their phases. The processors take turns, so a drift of the host's
    clock or state falls on all of them alike. Returns one JSON line for
    each."""
    from kmeans_tpu_torch.utils.profiling import collect_phases

    runs = {what: [] for what in procs}
    for _ in range(rounds):
        for what, (proc, mode) in procs.items():
            phases: dict = {}
            t0 = time.perf_counter()
            with collect_phases(phases):
                proc.reduce(k, image, reduce_mode=mode)
            runs[what].append((time.perf_counter() - t0, phases))
    lines = []
    for what, (proc, _) in procs.items():
        warm = runs[what][1:]
        e2e = statistics.median(r[0] for r in warm)
        phase_ms = {
            name: statistics.median(r[1].get(name, 0.0) for r in warm) * 1e3
            for name in ("host_prep", "upload", "device", "lloyd_sync", "readback", "unpack")
        }
        lines.append({
            "phase": "timing", "what": what,
            "card": card, "e2e_ms": e2e * 1e3, "mpix_per_s": HEIGHT * WIDTH / e2e / 1e6,
            "e2e_ms_each": [r[0] * 1e3 for r in warm], "phases_ms": phase_ms,
            "iterations": proc.last_iterations,
            "lloyd_checks": (proc.last_iterations - 1) // 8,
        })
    return lines


def launch_counts():
    """`(assign, meld, accumulator)` kernel launches since the last reset."""
    from kmeans_tpu_torch.ops import kernels

    return (kernels.launches("assign_packed"), kernels.launches("meld_packed"),
            kernels.launches("lloyd_accumulate"))


def reset_launch_counts() -> None:
    from kmeans_tpu_torch.ops import kernels

    kernels.LAUNCHES_BY_MODE.clear()


def mode_counts() -> dict:
    """Launches since the last reset as `{"wrapper metric tier": count}`."""
    from kmeans_tpu_torch.ops import kernels

    return {" ".join(key): n for key, n in sorted(kernels.LAUNCHES_BY_MODE.items())}


def check_against_plain(name, out, dev, cents, mode, metric, k, fast=False):
    """A 4K output against the plain version's output for the same
    palette: replace/dither through `assign_packed_reference`, meld
    through `meld_packed_reference`. CIE94 must be equal; CIEDE2000 within
    1 u8 step on at most 1e-4 of the pixels (the kernels' bars). Returns
    the JSON line."""
    from kmeans_tpu_torch.api import _lab_palette_to_u8, _unpack_gather, _unpack_meld
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold

    if mode == "meld":
        words = kernels.meld_packed_reference(dev, cents, metric=metric, fast=fast)
        plain = _unpack_meld(words.cpu().numpy(), HEIGHT, WIDTH, k)
    else:
        thr = dither_threshold(cents, metric=metric) if mode == "dither" else 0.0
        words = kernels.assign_packed_reference(dev, cents, thr, mode=mode, metric=metric,
                                                fast=fast)
        plain = _unpack_gather(words.cpu().numpy(), HEIGHT, WIDTH, k,
                               _lab_palette_to_u8(cents)[0].cpu().numpy())
    px = out.pixels
    step = np.abs(plain.astype(np.int64) - px).max(-1)
    differ = int((step > 0).sum())
    line = {"phase": "slice_vs_plain", "call": name, "metric": metric, "fast": fast,
            "differing_pixels": differ, "max_channel_step": int(step.max()),
            "colors": len(unique_rgba(px))}
    emit(line)
    ok = differ == 0 if metric == "cie94" else (
        step.max() <= 1 and differ <= 1e-4 * HEIGHT * WIDTH)
    if px.shape != (HEIGHT, WIDTH, 4) or not (px[..., 3] == 255).all() or not ok:
        raise AssertionError(f"{name}: {line}")
    return line


def drive_meld_and_cie2000(proc, image, find_colors, dev, device) -> dict:
    """The meld slice (`proc`, CIE94: a k=8 meld reduce and a 16-colour
    meld find), the CIEDE2000 slice (`delta_e="2000"`: replace, dither and
    meld reduces, a palette and a meld find) and the full-resolution
    CIEDE2000 reduce, each with its launch counts set to 0 just before it
    and read just after; then each output against the plain version."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import _colors_to_lab

    reset_launch_counts()
    out_meld = proc.reduce(K, image, reduce_mode=ReduceMode.MELD)
    find_meld = proc.find(image, find_colors, ReduceMode.MELD)
    torch.cuda.synchronize()
    counts_meld = launch_counts()

    proc2000 = ImageProcessor(device="cuda", delta_e="2000")
    reset_launch_counts()
    outs = {mode: proc2000.reduce(K, image, reduce_mode=mode)
            for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD)}
    iters_2000 = proc2000.last_iterations
    pal_2000 = proc2000.palette(K, image)
    find_2000 = proc2000.find(image, find_colors, ReduceMode.MELD)
    torch.cuda.synchronize()
    counts_2000 = launch_counts()

    full2000 = ImageProcessor(device="cuda", delta_e="2000", train_max_size=None)
    reset_launch_counts()
    t0 = time.perf_counter()
    out_full = full2000.reduce(K, image)
    torch.cuda.synchronize()
    full_seconds = time.perf_counter() - t0
    counts_full_2000 = launch_counts()

    emit({"phase": "slice", "what": "meld and delta_e=2000 slices",
          "launches_meld_slice": counts_meld, "launches_2000_slice": counts_2000,
          "launches_full_res_2000": counts_full_2000,
          "iterations_2000": iters_2000, "iterations_full_res_2000": full2000.last_iterations,
          "full_res_2000_seconds": full_seconds,
          "palette_2000": ["#%02X%02X%02X" % tuple(c[:3]) for c in pal_2000]})
    want = {"meld": (0, 2, 0), "2000": (2, 2, 0), "full 2000": (1, 0, full2000.last_iterations)}
    got = {"meld": counts_meld, "2000": counts_2000, "full 2000": counts_full_2000}
    if got != want or pal_2000.shape != (K, 4):
        raise AssertionError(f"launch counts (assign, meld, accumulator) {got}, want {want}")

    cents = proc.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    cents_2000 = proc2000.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    find_lab = torch.from_numpy(_colors_to_lab(find_colors)).to(device)
    check_against_plain("reduce meld", out_meld, dev, cents, "meld", "cie94", K)
    check_against_plain("find meld", find_meld, dev, find_lab, "meld", "cie94", 16)
    for mode, out in outs.items():
        check_against_plain(f"reduce {mode.value} delta_e=2000", out, dev, cents_2000,
                            mode.value, "cie2000", K)
    check_against_plain("find meld delta_e=2000", find_2000, dev, find_lab, "meld", "cie2000", 16)
    full_cents = full2000.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    check_against_plain("full-resolution reduce replace delta_e=2000", out_full, dev,
                        full_cents, "replace", "cie2000", K)
    return {"proc2000": proc2000, "counts_meld": counts_meld, "counts_2000": counts_2000,
            "counts_full_2000": counts_full_2000}


def fast_kernel_checks(device, lab_4k, small_lab) -> dict:
    """The six fast modes against their plain versions on the card: assign
    and meld under the factorized CIE94 and the pruned CIEDE2000 tier (0
    mismatched words; k = 513 falls back to exact and must also equal the
    exact kernel's words), and the accumulator's factorized, algebraic and
    pruned forms (counts equal, sums within 1e-5 of scale, equal totals
    twice). `k_active` 5 and 12 leave candidate slots unfilled. Returns the
    largest deviation of each mode, for the kernels' summary."""
    import torch

    from kmeans_tpu_torch.ops import kernels

    failures = []
    err = {}
    for metric in ("cie94", "cie2000"):
        cases = []
        for k in FAST_KS:
            cases += [(61, 97, k, "replace", None, 0), (257, 129, k, "dither", None, 3)]
        cases += [(61, 97, 64, "dither", 5, 0), (61, 97, 256, "replace", 12, 0),
                  (257, 129, 129, "replace", 100, 0), (HEIGHT, WIDTH, FAST_K, "replace", None, 0)]
        for h, w, k, mode, k_active, row_offset in cases:
            mism, diff, flips, _ = compare_case(h, w, k, mode, device, k_active, row_offset,
                                                metric=metric, fast=True)
            err["assign", metric] = max(err.get(("assign", metric), 0), diff)
            emit({"phase": "fast_kernel_vs_plain", "h": h, "w": w, "k": k, "mode": mode,
                  "k_active": k_active, "row_offset": row_offset, "metric": metric,
                  "tier": kernels.assign_tier(True, metric, k), "mismatched_words": mism,
                  "flipped_indices": flips})
            if mism:
                failures.append(f"fast_kernel_vs_plain {h}x{w} k={k} {mode} {metric}: {mism}")
        meld_cases = [(61, 97, k, None) for k in FAST_KS]
        meld_cases += [(257, 129, 64, 5), (61, 97, 256, 12), (HEIGHT, WIDTH, FAST_K, None)]
        for h, w, k, k_active in meld_cases:
            line = meld_case(h, w, k, metric, device, k_active=k_active, fast=True)
            emit(line)
            err["meld", metric] = max(err.get(("meld", metric), 0), line["max_channel_step"])
            if line["mismatched_words"]:
                failures.append(f"fast_meld_kernel_vs_plain: {line}")
        # Past 512 colours `fast` must change nothing on the card either.
        rgb = torch.from_numpy(np.random.default_rng(SEED + 513).integers(
            0, 256, (61, 97, 3), dtype=np.uint8)).to(device)
        cents = random_palette_lab(513, SEED + 513, device)
        same = (torch.equal(kernels.assign_packed(rgb, cents, 0.0, metric=metric, fast=True),
                            kernels.assign_packed(rgb, cents, 0.0, metric=metric))
                and torch.equal(kernels.meld_packed(rgb, cents, metric=metric, fast=True),
                                kernels.meld_packed(rgb, cents, metric=metric)))
        emit({"phase": "fast_kernel_vs_plain", "k": 513, "metric": metric,
              "fast_equals_exact_kernel": same})
        if not same:
            failures.append(f"k=513 {metric}: fast differs from the exact kernel")

    accum_cases = [(small_lab, k, {"metric": "cie94"}) for k in (8, 17, 64, 256, 512)]
    accum_cases += [(small_lab, k, {"metric": "cie94", "inertia": True}) for k in (8, 64, 512)]
    accum_cases += [(small_lab, k, {"metric": "cie2000"}) for k in (17, 64, 129, 512)]
    accum_cases += [
        (small_lab, 24, {"metric": "cie94", "k_active": 20, "bf16": True}),
        (small_lab, 17, {"metric": "cie94", "k_active": 11, "weighted": True, "inertia": True}),
        (small_lab, 256, {"metric": "cie2000", "k_active": 12, "inertia": True}),
        (small_lab, 64, {"metric": "cie2000", "k_active": 5, "weighted": True, "bf16": True}),
        (small_lab, 16, {"metric": "cie2000", "inertia": True}),  # at kp <= 16: exact
        (lab_4k, FAST_K, {"metric": "cie94"}),
        (lab_4k, FAST_K, {"metric": "cie94", "inertia": True}),
        (lab_4k, FAST_K, {"metric": "cie2000", "inertia": True}),
    ]
    for lab, k, opts in accum_cases:
        line = accum_case(lab, k, device, fast=True, **opts)
        emit(line)
        err["lloyd", line["tier"]] = max(err.get(("lloyd", line["tier"]), 0.0),
                                         line["max_abs_err"])
        if not (line["counts_equal"] and line["deterministic"]
                and line["max_err_over_scale"] <= 1e-5):
            failures.append(f"fast_lloyd_kernel_vs_plain k={k} {opts}: {line}")
    if failures:
        raise AssertionError("; ".join(failures))
    return err


def drive_fast(image, dev, device, lab_4k) -> dict:
    """The fast slice at full width: `ImageProcessor(fast=True)` through
    reduce, find and palette at k = 64 and 256 under both metrics, on the
    shrunk and the full-resolution training. Each path is driven with the
    launch counts set to 0 just before it and read just after; then each
    output is held against the plain version's for the same palette.
    Returns the launches of each path by kernel mode and the trained
    centroids."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import _colors_to_lab
    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 256)
    colors = rng.integers(0, 256, (FAST_K_LARGE, 4), dtype=np.uint8)
    colors[:, 3] = 255
    img = Image((WIDTH, HEIGHT), image)
    modes = (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD)
    paths, seconds = {}, {}

    def run(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        paths[name] = mode_counts()
        return out

    fast94 = ImageProcessor(device="cuda", fast=True)
    fast2000 = ImageProcessor(device="cuda", fast=True, delta_e="2000")
    full94 = ImageProcessor(device="cuda", fast=True, train_max_size=None, restarts=2)
    full2000 = ImageProcessor(device="cuda", fast=True, train_max_size=None, delta_e="2000")
    out94 = run("shrunk cie94", lambda: (
        {m: fast94.reduce(FAST_K, image, reduce_mode=m) for m in modes},
        {m: fast94.find(image, colors, m) for m in (ReduceMode.REPLACE, ReduceMode.MELD)}))
    out2000 = run("shrunk cie2000", lambda: (
        {m: fast2000.reduce(FAST_K, image, reduce_mode=m)
         for m in (ReduceMode.REPLACE, ReduceMode.MELD)},
        {m: fast2000.find(image, colors, m) for m in (ReduceMode.REPLACE, ReduceMode.MELD)}))
    out_full94 = run("full resolution cie94 restarts=2", lambda: full94.reduce(FAST_K, image))
    iters_full94 = full94.last_iterations
    pal_256 = run("full resolution cie2000 palette", lambda: full2000.palette(FAST_K_LARGE, image))
    iters_full2000 = full2000.last_iterations

    # The centroids of each training again, outside the counted paths.
    cents = {
        "cie94": fast94.extract_palette_kmeans(img, FAST_K),
        "cie2000": fast2000.extract_palette_kmeans(img, FAST_K),
        "full cie94": full94.extract_palette_kmeans(img, FAST_K),
        "full cie2000 256": full2000.extract_palette_kmeans(img, FAST_K_LARGE),
    }
    # The algebraic form is the accumulator's `fast=True` with the inertia
    # column under CIE94. No route of the API reaches it (the restarts'
    # winner pass runs exact under CIE94), so its path is the wrapper
    # itself: the inertia of the trained palette over the 4K pixels.
    planes, n_valid = kernels.pack_lab_planes(lab_4k)
    inertia_fast = run("inertia reading cie94", lambda: kernels.lloyd_accumulate(
        planes, cents["full cie94"], n_valid, emit_inertia=True, fast=True))
    inertia_exact = kernels.lloyd_accumulate(planes, cents["full cie94"], n_valid,
                                             emit_inertia=True)

    seeds = km.derive_restart_seeds(HEIGHT * WIDTH, km.reference_seed_index(WIDTH, HEIGHT), 2)
    restart_iters = [km.fit_large(lab_4k, FAST_K, s, fast=True)[1] for s in seeds.tolist()]
    want = {
        "shrunk cie94": {"assign_packed cie94 factor": 3, "meld_packed cie94 factor": 2,
                         "dither_threshold cie94 exact": 1},
        "shrunk cie2000": {"assign_packed cie2000 prune": 2, "meld_packed cie2000 prune": 2},
        "full resolution cie94 restarts=2": {
            "assign_packed cie94 factor": 1, "lloyd_accumulate cie94 exact": 2,
            "lloyd_accumulate cie94 factor": sum(restart_iters)},
        "full resolution cie2000 palette": {"lloyd_accumulate cie2000 prune": iters_full2000},
        "inertia reading cie94": {"lloyd_accumulate cie94 algebraic": 1},
    }
    emit({"phase": "fast_slice", "launches_by_path": paths, "seconds": seconds,
          "iterations": {"full cie94 winner": iters_full94, "full cie94 restarts": restart_iters,
                         "full cie2000 k=256": iters_full2000,
                         "shrunk cie94": fast94.last_iterations,
                         "shrunk cie2000": fast2000.last_iterations},
          "inertia_fast_over_exact": float(inertia_fast[:, 4].sum() / inertia_exact[:, 4].sum())})
    if paths != want:
        raise AssertionError(f"fast slice launches {paths}, want {want}")
    if pal_256.shape != (FAST_K_LARGE, 4) or not (pal_256[:, 3] == 255).all():
        raise AssertionError(f"fast palette(256): shape {pal_256.shape}")
    if not 0.999 <= float(inertia_fast[:, 4].sum() / inertia_exact[:, 4].sum()) <= 1.001:
        raise AssertionError("the algebraic inertia is not the exact one to 1e-3")

    find_lab = torch.from_numpy(_colors_to_lab(colors)).to(device)
    for mode, out in out94[0].items():
        check_against_plain(f"fast reduce k={FAST_K} {mode.value}", out, dev, cents["cie94"],
                            mode.value, "cie94", FAST_K, fast=True)
    for mode, out in out94[1].items():
        check_against_plain(f"fast find k={FAST_K_LARGE} {mode.value}", out, dev, find_lab,
                            mode.value, "cie94", FAST_K_LARGE, fast=True)
    for mode, out in out2000[0].items():
        check_against_plain(f"fast reduce k={FAST_K} {mode.value} delta_e=2000", out, dev,
                            cents["cie2000"], mode.value, "cie2000", FAST_K, fast=True)
    for mode, out in out2000[1].items():
        check_against_plain(f"fast find k={FAST_K_LARGE} {mode.value} delta_e=2000", out, dev,
                            find_lab, mode.value, "cie2000", FAST_K_LARGE, fast=True)
    check_against_plain(f"fast full-resolution reduce k={FAST_K} restarts=2", out_full94, dev,
                        cents["full cie94"], "replace", "cie94", FAST_K, fast=True)
    # palette(256): the pruned accumulator's totals for the trained
    # centroids against the plain version's.
    got = kernels.lloyd_accumulate(planes, cents["full cie2000 256"], n_valid,
                                   metric="cie2000", fast=True)
    plain = kernels.lloyd_accumulate_reference(planes, cents["full cie2000 256"], n_valid,
                                               metric="cie2000", fast=True)
    scale = plain.double().abs() + 128.0 * plain[:, 3:4].double()
    worst = float(((got.double() - plain.double()).abs() / scale.clamp(min=1e-300)).max())
    counts_equal = bool(torch.equal(got[:, 3], plain[:, 3]))
    emit({"phase": "slice_vs_plain", "call": "fast full-resolution palette k=256 delta_e=2000",
          "counts_equal": counts_equal, "max_err_over_scale": worst})
    if not counts_equal or worst > 1e-5:
        raise AssertionError("the pruned accumulator disagrees with plain on the trained palette")
    return {"paths": paths, "cents": cents, "find_lab": find_lab}


def _pixels_moved(a_words, b_words, k, meld):
    """Pixels of the 4K image whose output differs between two launches:
    `(any difference, more than 1 u8 step)` for meld, `(index differs,
    None)` for assign."""
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.utils.packing import (
        pack_bits,
        unpack_rgb24_tile_words,
        unpack_tile_words,
    )

    rows = kernels.quant_tile_rows(k)
    if meld:
        a = unpack_rgb24_tile_words(a_words.cpu().numpy(), HEIGHT, WIDTH, rows).astype(np.int16)
        b = unpack_rgb24_tile_words(b_words.cpu().numpy(), HEIGHT, WIDTH, rows).astype(np.int16)
        step = np.abs(a - b).max(-1)
        return int((step > 0).sum()), int((step > 1).sum())
    a = unpack_tile_words(a_words.cpu().numpy(), HEIGHT, WIDTH, pack_bits(k), rows)
    b = unpack_tile_words(b_words.cpu().numpy(), HEIGHT, WIDTH, pack_bits(k), rows)
    return int((a != b).sum()), None


def fast_vs_exact(dev, lab_4k, palettes) -> list:
    """For each `(what, metric, centroids)`: the share of the 4K image's
    pixels that each fast mode assigns or colours otherwise than the exact
    kernel on the same palette, and the share of pixels that change
    cluster in the accumulator (half the sum of |count differences|, a
    lower bound on the pixels moved). The reference holds its fast tiers
    to 1e-3, and so does this check on a trained palette (its `limit`),
    where the readings on an H100 were 0 to 3.7e-5. Seeded random colours
    lie far from the image's pixels, and there the pruned screen at m = 8
    loses more true nearest centroids (read on an H100 at k = 64: assign
    1.7e-3, meld 1.0e-2, count drift 1.7e-3): those palettes are reported
    against the same bar and fail the run only above 5e-2."""
    from kmeans_tpu_torch.ops import kernels

    planes, n_valid = kernels.pack_lab_planes(lab_4k)
    n = HEIGHT * WIDTH
    lines = []
    for what, metric, cents in palettes:
        k = cents.shape[0]
        assign = _pixels_moved(kernels.assign_packed(dev, cents, 0.0, metric=metric, fast=True),
                               kernels.assign_packed(dev, cents, 0.0, metric=metric), k, False)
        meld = _pixels_moved(kernels.meld_packed(dev, cents, metric=metric, fast=True),
                             kernels.meld_packed(dev, cents, metric=metric), k, True)
        exact = kernels.lloyd_accumulate(planes, cents, n_valid, metric=metric,
                                         emit_inertia=True)
        line = {"phase": "fast_vs_exact", "palette": what, "k": k, "metric": metric,
                "pixels": n, "bar": 1e-3, "limit": 1e-3 if what == "trained" else 5e-2,
                "assign_share": assign[0] / n, "meld_share": meld[0] / n,
                "meld_share_over_1_step": meld[1] / n}
        for inertia in (False, True):
            fast = kernels.lloyd_accumulate(planes, cents, n_valid, metric=metric,
                                            emit_inertia=inertia, fast=True)
            tier = kernels.accum_tier(True, metric, k, inertia)
            drift = float((fast[:, 3] - exact[:, 3]).abs().sum()) / 2 / n
            line[f"lloyd_{tier}_count_drift_share"] = drift
            if inertia:
                line[f"lloyd_{tier}_inertia_over_exact"] = float(
                    fast[:, 4].sum() / exact[:, 4].sum())
        emit(line)
        lines.append(line)
        shares = [v for key, v in line.items() if key.endswith("share")]
        if max(shares) > line["limit"]:
            raise AssertionError(f"fast_vs_exact: {line}")
    return lines


def time_fast(dev, lab_4k, palettes, flush, card) -> dict:
    """Cold-L2 times of the fast modes at 4K in turns with the exact
    kernel at the same k (exact, fast, fast, exact; the mean of each
    pair), beside their bounds; the plain versions once, at k = 64.
    Returns `{(kernel, metric, tier): (ms, plain_ms, bound_ms, bound_by)}`
    at k = 64."""
    from kmeans_tpu_torch.ops import kernels

    planes, n_valid = kernels.pack_lab_planes(lab_4k)
    n_pix = planes.shape[1] * kernels.LANES
    n = HEIGHT * WIDTH
    summary = {}
    for what, metric, cents in palettes:
        k = cents.shape[0]
        rows = kernels.quant_tile_rows(k) * kernels.LANES
        n_pad = -(-n // rows) * rows
        tier = kernels.assign_tier(True, metric, k)
        reps = 3 if metric == "cie2000" else 10
        calls = {
            "assign": (lambda fast: kernels.assign_packed(dev, cents, 0.0, metric=metric, fast=fast),
                       lambda fast: kernels.assign_packed_reference(dev, cents, 0.0, metric=metric,
                                                                    fast=fast),
                       lambda t: assign_bound(n, n_pad, n_pad // 4, k, k, metric, t), tier),
            "meld": (lambda fast: kernels.meld_packed(dev, cents, metric=metric, fast=fast),
                     lambda fast: kernels.meld_packed_reference(dev, cents, metric=metric, fast=fast),
                     lambda t: meld_bound(n, n_pad, k, k, metric, t), tier),
            "lloyd": (lambda fast: kernels.lloyd_accumulate(planes, cents, n_valid, metric=metric,
                                                            fast=fast),
                      lambda fast: kernels.lloyd_accumulate_reference(planes, cents, n_valid,
                                                                      metric=metric, fast=fast),
                      lambda t: accum_bound(n_pix, n_valid, k, k, 4, metric=metric, tier=t),
                      kernels.accum_tier(True, metric, k, False)),
        }
        if metric == "cie94":
            calls["lloyd+inertia"] = (
                lambda fast: kernels.lloyd_accumulate(planes, cents, n_valid, emit_inertia=True,
                                                      fast=fast),
                lambda fast: kernels.lloyd_accumulate_reference(planes, cents, n_valid,
                                                                emit_inertia=True, fast=fast),
                lambda t: accum_bound(n_pix, n_valid, k, k, 5, tier=t), "algebraic")
        for name, (kernel, plain, bound, fast_tier) in calls.items():
            turns = [cuda_ms(lambda: kernel(fast), reps, flush)
                     for fast in (False, True, True, False)]
            exact_ms, fast_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            plain_ms = cuda_ms(lambda: plain(True), 1, flush) if k == FAST_K else "not measured"
            bound_ms, bound_by = bound(fast_tier)
            exact_bound_ms, _ = bound("exact")
            emit({"phase": "timing",
                  "what": f"{name} 3840x2160 k={k} {metric} {fast_tier} vs exact, cold L2, "
                          f"{what} palette",
                  "card": card, "kernel_ms": fast_ms, "exact_kernel_ms": exact_ms,
                  "ms_in_turn": turns, "exact_over_fast": exact_ms / fast_ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "exact_bound_ms": exact_bound_ms, "share_of_bound": bound_ms / fast_ms})
            if k == FAST_K:
                summary[name, metric, fast_tier] = (fast_ms, plain_ms, bound_ms, bound_by)
    return summary


# --- Frame batching and palettes past 1024 colours ---------------------------

FRAMES_KS = (1, 8, 17, 257, 1024)
FRAMES_KS_2000 = (1, 8, 17, 257)
FRAME_SHAPES = ((61, 97), (30, 41))  # H not a multiple of 4: per-frame dither phase
COLOUR_OUT_KS = (1, 8, 1025, 2048, 16384)
N_FRAMES, FRAME_H, FRAME_W = 16, 1080, 1920
BIG_K = 2048  # past INDEXED_MAX_K: the colour-out pass
HUGE_K = 16384  # past one shared-memory chunk (STAGE_CHUNK) of centroids


def _frame_images(b, h, w, seed, device):
    rng = np.random.default_rng(seed)
    import torch

    return torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(device)


def _rgba_step(a, b):
    """Largest channel step of each pixel between two RGBA uint8 arrays."""
    return np.abs(a.astype(np.int64) - b.astype(np.int64)).max(-1)


def _frames_outputs(form, words, b, h, w, k):
    """`[b, h, w, 4]` RGBA (or `[b, h, w]` indices for packed) from a
    frames launch's host copy."""
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.utils.packing import (
        pack_bits,
        unpack_rgb24_tile_words,
        unpack_tile_words,
    )

    rows = kernels.quant_tile_rows(k)
    out = words.cpu().numpy()
    if form == "rgba":
        return out
    if form == "meld":
        return np.stack([unpack_rgb24_tile_words(out[f], h, w, rows) for f in range(b)])
    return np.stack([unpack_tile_words(out[f], h, w, pack_bits(k), rows) for f in range(b)])


def frames_case(form, b, h, w, k, metric, device, shared=False, fast=False, seed=7):
    """The frames mode of one kernel against its plain twin on one case:
    `b` frames (or one image `shared` by `b` palettes: frame stride 0),
    each with its own palette, `k_active` and dither threshold. Returns
    the case's JSON line: mismatched words, and the outputs' largest
    difference (index for packed, channel step for meld and RGBA)."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.quantize import dither_thresholds

    frames = _frame_images(b, h, w, seed + k + b, device)
    if shared:
        frames = frames[:1].expand(b, h, w, 3)
    rng = np.random.default_rng(seed + 31 * k)
    cents = srgb8_to_lab(torch.from_numpy(
        rng.integers(0, 256, (b, k, 3), dtype=np.uint8)).to(device)).contiguous()
    k_actives = [max(1, k - (f * k) // (b + 1)) for f in range(b)]
    thr = dither_thresholds(cents, k_actives, metric)
    if form == "meld":
        got = kernels.meld_frames_packed(frames, cents, k_actives, metric, fast)
        want = kernels.meld_frames_packed_reference(frames, cents, k_actives, metric, fast)
    elif form == "packed":
        got = kernels.assign_frames_packed(frames, cents, thr, k_actives, "dither", metric, fast)
        want = kernels.assign_frames_packed_reference(frames, cents, thr, k_actives, "dither",
                                                      metric, fast)
    else:
        got = kernels.quantize_frames(frames, cents, thr, k_actives, "dither", metric, fast)
        want = kernels.quantize_frames_reference(frames, cents, thr, k_actives, "dither",
                                                 metric, fast)
    torch.cuda.synchronize()
    a = _frames_outputs(form, got, b, h, w, k)
    z = _frames_outputs(form, want, b, h, w, k)
    diff = (np.abs(a.astype(np.int64) - z.astype(np.int64)) if form == "packed"
            else _rgba_step(a, z))
    return {"phase": "frames_kernel_vs_plain", "form": form, "frames": b, "h": h, "w": w,
            "k": k, "k_actives": k_actives, "metric": metric, "shared_image": shared,
            "tier": kernels.assign_tier(fast, metric, k),
            "mismatched_words": int((got != want).sum().item()),
            "differing_pixels": int((diff > 0).sum()), "max_abs_err": int(diff.max()),
            "pixels": b * h * w}


def frames_kernel_checks(device) -> dict:
    """`frames_kernel_vs_plain`: the packed, meld and RGBA frames modes
    against their twins over B = 1, 3, 8, k = 1..1024, ragged frames, per-
    frame `k_active` and thresholds, frame stride 0, both metrics, and the
    fast tiers at k = 64: equal words (meld under CIEDE2000: within 1 u8
    step on 1e-4 of the pixels). Returns the largest error by (form,
    metric, tier)."""
    failures, err = [], {}
    cases = []
    for metric, ks in (("cie94", FRAMES_KS), ("cie2000", FRAMES_KS_2000)):
        for i, k in enumerate(ks):
            for j, form in enumerate(("packed", "meld", "rgba")):
                b = (1, 3, 8)[(i + j) % 3] if k < 257 or metric == "cie94" else 3
                if k == 1024:
                    b = 3 if form == "packed" else 1
                h, w = FRAME_SHAPES[(i + j) % 2]
                cases.append((form, b, h, w, k, metric, (i + j) % 4 == 3, False))
    for metric in ("cie94", "cie2000"):
        for form in ("packed", "meld"):
            cases.append((form, 3, 61, 97, FAST_K, metric, form == "meld", True))
    for form, b, h, w, k, metric, shared, fast in cases:
        line = frames_case(form, b, h, w, k, metric, device, shared, fast)
        emit(line)
        key = (form, metric, line["tier"])
        err[key] = max(err.get(key, 0), line["max_abs_err"])
        ok = line["mismatched_words"] == 0 or (
            form == "meld" and metric == "cie2000" and line["max_abs_err"] <= 1
            and line["differing_pixels"] <= 1e-4 * line["pixels"])
        if not ok:
            failures.append(f"frames_kernel_vs_plain: {line}")
    if failures:
        raise AssertionError("; ".join(failures))
    return err


def colour_out_checks(device) -> dict:
    """`colour_out_vs_plain`: `quantize_rgba` against its twin at k = 1,
    8, 1025, 2048, 16384 (one chunk of staged centroids below 4096, the
    chunked instance above), replace and dither, CIE94, and at k = 8, 1025
    under CIEDE2000; `assign_u8` at k = 8, 256; the meld kernel at
    k = 16384 (the staging repair); and the chunked instances under
    CIEDE2000 at k = 1025 with `STAGE_CHUNK` lowered to 256 (the twin of
    a 16384-entry CIEDE2000 palette takes minutes). Equal RGBA, indices
    and words (meld under CIEDE2000: within 1 u8 step on 1e-4 of the
    pixels). Returns the largest error of each kernel instance."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.utils.packing import unpack_rgb24_tile_words

    failures, err = [], {}
    rng = np.random.default_rng(SEED + 77)
    rgb = torch.from_numpy(rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)).to(device)
    default_chunk = kernels.STAGE_CHUNK
    cases = [(k, mode, "cie94", default_chunk) for k in COLOUR_OUT_KS
             for mode in ("replace", "dither")]
    cases += [(k, mode, "cie2000", default_chunk) for k in (8, 1025)
              for mode in ("replace", "dither")]
    for k, mode, metric, chunk in cases + [(1025, "dither", "cie2000", 256)]:
        kernels.STAGE_CHUNK = chunk
        cents = random_palette_lab(k, SEED + k, device)
        thr = dither_threshold(cents, metric=metric) if mode == "dither" else 0.0
        got = kernels.quantize_rgba(rgb, cents, thr, mode=mode, metric=metric)
        want = kernels.quantize_rgba_reference(rgb, cents, thr, mode=mode, metric=metric)
        torch.cuda.synchronize()
        step = _rgba_step(got.cpu().numpy(), want.cpu().numpy())
        chunked = k > kernels.STAGE_CHUNK
        line = {"phase": "colour_out_vs_plain", "kernel": "quantize_rgba", "k": k,
                "mode": mode, "metric": metric, "chunked": chunked,
                "differing_pixels": int((step > 0).sum()), "max_abs_err": int(step.max())}
        emit(line)
        key = ("quantize_rgba", metric, chunked)
        err[key] = max(err.get(key, 0), line["max_abs_err"])
        if line["differing_pixels"]:
            failures.append(f"colour_out_vs_plain: {line}")
    for k, mode in ((8, "replace"), (256, "dither")):
        cents = random_palette_lab(k, SEED + k, device)
        thr = dither_threshold(cents) if mode == "dither" else 0.0
        got = kernels.assign_u8(rgb, cents, thr, mode=mode)
        want = kernels.assign_u8_reference(rgb, cents, thr, mode=mode)
        diff = int((got.int() - want.int()).abs().max().item())
        emit({"phase": "colour_out_vs_plain", "kernel": "assign_u8", "k": k, "mode": mode,
              "metric": "cie94", "flipped_indices": int((got != want).sum().item()),
              "max_abs_err": diff})
        err["assign_u8", "cie94", False] = max(err.get(("assign_u8", "cie94", False), 0), diff)
        if diff:
            failures.append(f"assign_u8 k={k} {mode}: {diff}")
    for k, metric, chunk in ((HUGE_K, "cie94", default_chunk), (1025, "cie2000", 256)):
        kernels.STAGE_CHUNK = chunk
        cents = random_palette_lab(k, SEED + k, device)
        cents[-1] = cents[0]  # a repeated colour: its pixels blend to NaN, written black
        got = kernels.meld_packed(rgb, cents, metric=metric)
        want = kernels.meld_packed_reference(rgb, cents, metric=metric)
        torch.cuda.synchronize()
        rows = kernels.quant_tile_rows(k)
        step = _rgba_step(unpack_rgb24_tile_words(got.cpu().numpy(), 61, 97, rows),
                          unpack_rgb24_tile_words(want.cpu().numpy(), 61, 97, rows))
        line = {"phase": "colour_out_vs_plain", "kernel": "meld_packed", "k": k,
                "metric": metric, "chunked": k > kernels.STAGE_CHUNK,
                "mismatched_words": int((got != want).sum().item()),
                "differing_pixels": int((step > 0).sum()), "max_abs_err": int(step.max())}
        emit(line)
        err["meld_packed", metric, True] = max(err.get(("meld_packed", metric, True), 0),
                                               line["max_abs_err"])
        if line["mismatched_words"] and (metric == "cie94" or line["max_abs_err"] > 1
                                         or line["differing_pixels"] > 1e-4 * 61 * 97):
            failures.append(f"meld at k={k}: {line}")
    kernels.STAGE_CHUNK = default_chunk
    if failures:
        raise AssertionError("; ".join(failures))
    return err


def frames_rgba(seed, b=N_FRAMES, h=FRAME_H, w=FRAME_W) -> list:
    """`b` synthetic RGBA frames, each its own seed."""
    return [synthetic_image(h, w, seed=seed + f) for f in range(b)]


def drive_frames(image, frames, device) -> dict:
    """The slice at full width: `reduce_images` on 16 frames of 1920x1080
    (k = 8 replace, dither and meld; k = 64 `fast=True` replace and meld
    under both metrics; k = 2048 on two frames), `find_batch` with 16
    colours (dither, meld), `palette_images` at k = 8, `reduce_batch` on
    the 4K image at ks (4, 8, 16, 32), `reduce(2048)` replace and dither,
    `find` with 2048 colours, and `find` with 16384 colours on one frame
    (replace and meld: the chunked instances). Each path is driven with
    the launch counts set to 0 just before it and read just after; each
    must launch exactly its one kernel. Returns the outputs, the paths'
    launches and seconds, and the processors."""
    import torch

    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import _colors_to_lab
    from kmeans_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 16)
    colors16 = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    colors_big = rng.integers(0, 256, (BIG_K, 4), dtype=np.uint8)
    colors_huge = rng.integers(0, 256, (HUGE_K, 4), dtype=np.uint8)
    for c in (colors16, colors_big, colors_huge):
        c[:, 3] = 255
    dev4k = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(device)
    lab16 = torch.from_numpy(_colors_to_lab(colors16)).to(device)
    procs = {"94": ImageProcessor(device="cuda"),
             "fast94": ImageProcessor(device="cuda", fast=True),
             "fast2000": ImageProcessor(device="cuda", fast=True, delta_e="2000")}
    p94 = procs["94"]
    R, D, M = ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD
    calls = {
        "reduce_images k=8 replace": lambda: p94.reduce_images(frames, K, R),
        "reduce_images k=8 dither": lambda: p94.reduce_images(frames, K, D),
        "reduce_images k=8 meld": lambda: p94.reduce_images(frames, K, M),
        "reduce_images k=64 fast replace": lambda: procs["fast94"].reduce_images(
            frames, FAST_K, R),
        "reduce_images k=64 fast meld": lambda: procs["fast94"].reduce_images(frames, FAST_K, M),
        "reduce_images k=64 fast replace delta_e=2000": lambda: procs["fast2000"].reduce_images(
            frames, FAST_K, R),
        "reduce_images k=64 fast meld delta_e=2000": lambda: procs["fast2000"].reduce_images(
            frames, FAST_K, M),
        "reduce_images k=2048 replace, 2 frames": lambda: p94.reduce_images(frames[:2], BIG_K),
        "find_batch 16 colours dither": lambda: p94.find_batch(frames, colors16, D),
        "find_batch 16 colours meld": lambda: p94.find_batch(frames, colors16, M),
        "palette_images k=8": lambda: p94.palette_images(frames, K),
        "reduce_batch 4K ks (4, 8, 16, 32)": lambda: p94.reduce_batch(image, (4, 8, 16, 32)),
        "reduce 4K k=2048 replace": lambda: p94.reduce(BIG_K, image),
        "reduce 4K k=2048 dither": lambda: p94.reduce(BIG_K, image, reduce_mode=D),
        "find 4K 2048 colours": lambda: p94.find(image, colors_big),
        "find 1080p 16384 colours replace": lambda: p94.find(frames[0], colors_huge),
        "find 1080p 16384 colours meld": lambda: p94.find(frames[0], colors_huge, M),
        # No entry point of either package reaches the u8-index form: its
        # path is the wrapper itself.
        "assign_u8 4K 16 colours, direct wrapper call": lambda: kernels.assign_u8(
            dev4k, lab16, 0.0),
    }
    frames_launch = {"assign_frames_packed cie94 exact": 1}
    threshold = {"dither_threshold cie94 exact": 1}  # one launch for all B palettes
    want = {
        "reduce_images k=8 replace": frames_launch,
        "reduce_images k=8 dither": {**frames_launch, **threshold},
        "reduce_images k=8 meld": {"meld_frames_packed cie94 exact": 1},
        "reduce_images k=64 fast replace": {"assign_frames_packed cie94 factor": 1},
        "reduce_images k=64 fast meld": {"meld_frames_packed cie94 factor": 1},
        "reduce_images k=64 fast replace delta_e=2000": {"assign_frames_packed cie2000 prune": 1},
        "reduce_images k=64 fast meld delta_e=2000": {"meld_frames_packed cie2000 prune": 1},
        "reduce_images k=2048 replace, 2 frames": {"quantize_frames cie94 exact": 1},
        "find_batch 16 colours dither": {"assign_packed cie94 exact": 1, **threshold},
        "find_batch 16 colours meld": {"meld_packed cie94 exact": 1},
        "palette_images k=8": {},
        "reduce_batch 4K ks (4, 8, 16, 32)": frames_launch,
        "reduce 4K k=2048 replace": {"quantize_rgba cie94 exact": 1},
        "reduce 4K k=2048 dither": {"quantize_rgba cie94 exact": 1, **threshold},
        "find 4K 2048 colours": {"quantize_rgba cie94 exact": 1},
        "find 1080p 16384 colours replace": {"quantize_rgba cie94 exact-chunked": 1},
        "find 1080p 16384 colours meld": {"meld_packed cie94 exact-chunked": 1},
        "assign_u8 4K 16 colours, direct wrapper call": {"assign_u8 cie94 exact": 1},
    }
    outs, paths, seconds = {}, {}, {}
    for name, fn in calls.items():
        reset_launch_counts()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        paths[name] = mode_counts()
    emit({"phase": "frames_slice", "launches_by_path": paths, "seconds": seconds})
    if paths != want:
        raise AssertionError(f"frames slice launches {paths}, want {want}")
    return {"outs": outs, "paths": paths, "procs": procs, "colors16": colors16,
            "colors_big": colors_big, "colors_huge": colors_huge}


def frames_slice_vs_plain(image, frames, device, drive) -> dict:
    """Each output of `drive_frames` against the plain twins on the same
    palettes (the trainings run again outside the counted paths; a
    training is deterministic): CIE94 equal pixels, CIEDE2000 within 1 u8
    step on 1e-4 of them; `palette_images` a palette of 8 opaque colours.
    Returns the trained palettes, for the times."""
    import torch

    from kmeans_tpu_torch import Image
    from kmeans_tpu_torch.api import _colors_to_lab, _lab_palette_to_u8, _unpack
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold, dither_thresholds

    outs, procs = drive["outs"], drive["procs"]
    stack = torch.from_numpy(np.stack([f[..., :3] for f in frames])).to(device)
    dev = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(device)
    h, w = FRAME_H, FRAME_W

    def check(name, got_images, want_rgba, metric):
        step = np.stack([_rgba_step(g.pixels, x) for g, x in zip(got_images, want_rgba)])
        differ = int((step > 0).sum())
        line = {"phase": "slice_vs_plain", "call": name, "metric": metric,
                "differing_pixels": differ, "max_channel_step": int(step.max()),
                "pixels": int(step.size)}
        emit(line)
        ok = differ == 0 if metric == "cie94" else (
            step.max() <= 1 and differ <= 1e-4 * step.size)
        if not ok or not all((g.pixels[..., 3] == 255).all() for g in got_images):
            raise AssertionError(f"{name}: {line}")

    def plain_frames(cents, mode, metric, fast, frames_u8, k_actives=None):
        b, k = cents.shape[0], cents.shape[1]
        if mode == "meld":
            words = kernels.meld_frames_packed_reference(frames_u8, cents, k_actives, metric, fast)
            kind, pals = "meld", None
        else:
            thr = dither_thresholds(cents, k_actives, metric) if mode == "dither" else 0.0
            if k > kernels.INDEXED_MAX_K:
                return list(kernels.quantize_frames_reference(
                    frames_u8, cents, thr, k_actives, mode, metric, fast).cpu().numpy())
            words = kernels.assign_frames_packed_reference(frames_u8, cents, thr, k_actives,
                                                           mode, metric, fast)
            kind, pals = "indexed", _lab_palette_to_u8(cents)[0].cpu().numpy()
        words = words.cpu().numpy()
        return [_unpack(kind, words[f], frames_u8.shape[1], frames_u8.shape[2], k,
                        None if pals is None else pals[f]) for f in range(b)]

    palettes = {}
    for name, proc, k, mode, metric, fast in (
        ("reduce_images k=8 replace", procs["94"], K, "replace", "cie94", False),
        ("reduce_images k=8 dither", procs["94"], K, "dither", "cie94", False),
        ("reduce_images k=8 meld", procs["94"], K, "meld", "cie94", False),
        ("reduce_images k=64 fast replace", procs["fast94"], FAST_K, "replace", "cie94", True),
        ("reduce_images k=64 fast meld", procs["fast94"], FAST_K, "meld", "cie94", True),
        ("reduce_images k=64 fast replace delta_e=2000", procs["fast2000"], FAST_K, "replace",
         "cie2000", True),
        ("reduce_images k=64 fast meld delta_e=2000", procs["fast2000"], FAST_K, "meld",
         "cie2000", True),
    ):
        key = (k, metric)
        if key not in palettes:
            palettes[key] = proc._train_batched(stack, k, w, h)
        check(name, outs[name], plain_frames(palettes[key], mode, metric, fast, stack), metric)
    palettes[BIG_K, "cie94"] = procs["94"]._train_batched(stack[:2], BIG_K, w, h)
    check("reduce_images k=2048 replace, 2 frames", outs["reduce_images k=2048 replace, 2 frames"],
          plain_frames(palettes[BIG_K, "cie94"], "replace", "cie94", False, stack[:2]), "cie94")
    ks = [4, 8, 16, 32]
    cents_batch = procs["94"]._train_batched(dev, max(ks), WIDTH, HEIGHT, ks)
    check("reduce_batch 4K ks (4, 8, 16, 32)", outs["reduce_batch 4K ks (4, 8, 16, 32)"],
          plain_frames(cents_batch, "replace", "cie94", False,
                       dev[None].expand(len(ks), HEIGHT, WIDTH, 3), ks), "cie94")
    lab16 = torch.from_numpy(_colors_to_lab(drive["colors16"])).to(device)
    tall = np.concatenate([f[..., :3] for f in frames])  # 1080 rows: a multiple of 4
    tall_dev = torch.from_numpy(tall).to(device)
    for mode in ("dither", "meld"):
        thr = dither_threshold(lab16) if mode == "dither" else 0.0
        if mode == "meld":
            words, kind = kernels.meld_packed_reference(tall_dev, lab16), "meld"
        else:
            words, kind = kernels.assign_packed_reference(tall_dev, lab16, thr, mode=mode), \
                "indexed"
        plain = _unpack(kind, words.cpu().numpy(), N_FRAMES * h, w, 16,
                        _lab_palette_to_u8(lab16)[0].cpu().numpy())
        check(f"find_batch 16 colours {mode}", outs[f"find_batch 16 colours {mode}"],
              list(plain.reshape(N_FRAMES, h, w, 4)), "cie94")
    cents_big = procs["94"].extract_palette_kmeans(Image((WIDTH, HEIGHT), image), BIG_K)
    for mode in ("replace", "dither"):
        thr = dither_threshold(cents_big) if mode == "dither" else 0.0
        check(f"reduce 4K k=2048 {mode}", [outs[f"reduce 4K k=2048 {mode}"]],
              [kernels.quantize_rgba_reference(dev, cents_big, thr, mode=mode).cpu().numpy()],
              "cie94")
    lab_big = torch.from_numpy(_colors_to_lab(drive["colors_big"])).to(device)
    check("find 4K 2048 colours", [outs["find 4K 2048 colours"]],
          [kernels.quantize_rgba_reference(dev, lab_big, 0.0).cpu().numpy()], "cie94")
    lab_huge = torch.from_numpy(_colors_to_lab(drive["colors_huge"])).to(device)
    frame0 = stack[0]
    check("find 1080p 16384 colours replace", [outs["find 1080p 16384 colours replace"]],
          [kernels.quantize_rgba_reference(frame0, lab_huge, 0.0).cpu().numpy()], "cie94")
    check("find 1080p 16384 colours meld", [outs["find 1080p 16384 colours meld"]],
          [_unpack("meld", kernels.meld_packed_reference(frame0, lab_huge).cpu().numpy(), h, w,
                   HUGE_K, None)], "cie94")
    pal = outs["palette_images k=8"]
    emit({"phase": "frames_slice", "palette_images_k8": ["#%02X%02X%02X" % tuple(c[:3])
                                                         for c in pal]})
    if pal.shape != (K, 4) or not (pal[:, 3] == 255).all():
        raise AssertionError(f"palette_images: {pal.shape}")
    return {"palettes": palettes, "lab_big": lab_big, "lab_huge": lab_huge, "stack": stack,
            "dev": dev, "cents_big": cents_big}


def frames_card_vs_cpu() -> None:
    """One small batch on the card against the CPU: `reduce_images`,
    `reduce_batch`, `find_batch` (dither and meld) and `palette_images` on
    3 frames of 150x210: equal palettes; dither within 1e-4 of the pixels,
    meld within 1 u8 step on 1e-3."""
    from kmeans_tpu_torch import ImageProcessor, ReduceMode

    frames = frames_rgba(SEED + 50, 3, 150, 210)
    colors = np.random.default_rng(SEED + 51).integers(0, 256, (12, 3), dtype=np.uint8)
    card, cpu = ImageProcessor(device="cuda"), ImageProcessor(device="cpu")
    same_palette = bool((card.palette_images(frames, K) == cpu.palette_images(frames, K)).all())
    for mode in (ReduceMode.DITHER, ReduceMode.MELD):
        for name, fn in (("reduce_images", lambda p: p.reduce_images(frames, K, mode)),
                         ("reduce_batch", lambda p: p.reduce_batch(frames[0], (3, 8), mode)),
                         ("find_batch", lambda p: p.find_batch(frames, colors, mode))):
            step = np.stack([_rgba_step(a.pixels, b.pixels)
                             for a, b in zip(fn(card), fn(cpu))])
            differ = int((step > 0).sum())
            emit({"phase": "card_vs_cpu", "mode": f"{name} {mode.value}",
                  "differing_pixels": differ, "max_channel_step": int(step.max()),
                  "pixels": int(step.size), "same_palette_images": same_palette})
            bar = 1e-3 if mode is ReduceMode.MELD else 1e-4
            if (not same_palette or differ > bar * step.size
                    or (mode is ReduceMode.MELD and step.max() > 1)):
                raise AssertionError(f"card vs cpu {name} {mode.value}: {differ} pixels differ")


def time_frames(image, frames, device, card, drive, plain) -> dict:
    """The new kernel instances' times at the slice's shapes (cold L2,
    CUDA events), each beside its plain twin's time and its bound; the
    frames launch at 16x1080p k=8 in turns with 16 single-frame launches;
    `reduce_images` end to end in turns with 16 sequential `reduce` calls.
    Returns `{kernel entry: (ms, plain_ms, bound_ms, bound_by)}`."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_thresholds

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    stack, dev = plain["stack"], plain["dev"]
    h, w = FRAME_H, FRAME_W
    n_f = h * w
    out = {}

    def layout(k, ppw=1):
        rows = kernels.quant_tile_rows(k) * kernels.LANES
        n_pad = -(-n_f // rows) * rows
        return n_pad, n_pad // ppw

    def timed(entry, kernel, twin, bound, reps=10):
        out[entry] = (cuda_ms(kernel, reps, flush), cuda_ms(twin, 1, flush), *bound)
        emit({"phase": "timing", "what": entry, "card": card, "kernel_ms": out[entry][0],
              "plain_ms": out[entry][1], "bound_ms": out[entry][2], "bound_by": out[entry][3]})

    # The frames modes on the 16 frames' trained palettes.
    ks16 = [K] * N_FRAMES
    for metric, k, fast, tier in (("cie94", K, False, "exact"), ("cie94", FAST_K, True, "factor"),
                                  ("cie2000", FAST_K, True, "prune")):
        cents = plain["palettes"][k, metric]
        ka = [k] * N_FRAMES
        n_pad, n_words = layout(k, 32 // kernels.pack_bits(k))
        suffix = "" if tier == "exact" else (
            "[fast cie94, factorized]" if tier == "factor" else "[fast cie2000, pruned]")
        timed(f"assign_frames_packed{suffix}",
              lambda: kernels.assign_frames_packed(stack, cents, 0.0, None, "replace", metric,
                                                   fast),
              lambda: kernels.assign_frames_packed_reference(stack, cents, 0.0, None, "replace",
                                                             metric, fast),
              assign_bound(n_f, n_pad, n_words, k, ka, metric, tier), 5 if fast else 10)
        n_pad, _ = layout(k)
        timed(f"meld_frames_packed{suffix}",
              lambda: kernels.meld_frames_packed(stack, cents, None, metric, fast),
              lambda: kernels.meld_frames_packed_reference(stack, cents, None, metric, fast),
              meld_bound(n_f, n_pad, k, ka, metric, tier), 5 if fast else 10)
    cents2 = plain["palettes"][BIG_K, "cie94"]
    n_pad, _ = layout(BIG_K)
    timed("quantize_frames",
          lambda: kernels.quantize_frames(stack[:2], cents2, 0.0),
          lambda: kernels.quantize_frames_reference(stack[:2], cents2, 0.0),
          assign_bound(n_f, n_pad, n_pad, BIG_K, [BIG_K] * 2, palette_words=True), 3)
    # The colour-out and u8 modes at 4K, the chunked instances at 1080p.
    n_4k = HEIGHT * WIDTH
    rows = kernels.quant_tile_rows(BIG_K) * kernels.LANES
    n_pad_4k = -(-n_4k // rows) * rows
    cents_big = plain["cents_big"]
    timed("quantize_rgba", lambda: kernels.quantize_rgba(dev, cents_big, 0.0),
          lambda: kernels.quantize_rgba_reference(dev, cents_big, 0.0),
          assign_bound(n_4k, n_pad_4k, n_pad_4k, BIG_K, BIG_K, palette_words=True), 3)
    cents8 = plain["palettes"][K, "cie94"][0]
    rows = kernels.quant_tile_rows(K) * kernels.LANES
    n_pad8 = -(-n_4k // rows) * rows
    timed("assign_u8", lambda: kernels.assign_u8(dev, cents8, 0.0),
          lambda: kernels.assign_u8_reference(dev, cents8, 0.0),
          assign_bound(n_4k, n_pad8, n_pad8, K, K, out_bytes=1))
    lab_huge, frame0 = plain["lab_huge"], stack[0]
    n_pad, _ = layout(HUGE_K)
    timed("quantize_rgba[chunked]", lambda: kernels.quantize_rgba(frame0, lab_huge, 0.0),
          lambda: kernels.quantize_rgba_reference(frame0, lab_huge, 0.0),
          assign_bound(n_f, n_pad, n_pad, HUGE_K, HUGE_K, palette_words=True), 2)
    timed("meld_packed[chunked]", lambda: kernels.meld_packed(frame0, lab_huge),
          lambda: kernels.meld_packed_reference(frame0, lab_huge),
          meld_bound(n_f, n_pad, HUGE_K, HUGE_K, "cie94"), 2)

    # One frames launch against 16 single-frame launches, in turns.
    cents = plain["palettes"][K, "cie94"]
    thr = dither_thresholds(cents)

    def one_launch():
        kernels.assign_frames_packed(stack, cents, thr, None, "dither")

    def sixteen():
        for f in range(N_FRAMES):
            kernels.assign_packed(stack[f], cents[f], thr[f], mode="dither")

    turns = [cuda_ms(fn, 5, flush) for fn in (one_launch, sixteen, sixteen, one_launch)]
    emit({"phase": "timing", "what": "dither 16x1920x1080 k=8: one frames launch against 16 "
          "single-frame launches, in turns, cold L2", "card": card, "ms_in_turn": turns,
          "frames_launch_ms": (turns[0] + turns[3]) / 2,
          "sixteen_launches_ms": (turns[1] + turns[2]) / 2})

    # reduce_images end to end against 16 sequential reduce calls, in turns,
    # with their phases (summed over the 16 calls); then one of each profiled.
    from kmeans_tpu_torch.utils.profiling import collect_phases

    proc = drive["procs"]["94"]
    calls = {"reduce_images": lambda: proc.reduce_images(frames, K),
             "16 x reduce": lambda: [proc.reduce(K, f) for f in frames]}
    runs = {what: [] for what in calls}
    for what in ("reduce_images", "16 x reduce", "16 x reduce", "reduce_images",
                 "reduce_images", "16 x reduce"):
        phases: dict = {}
        t0 = time.perf_counter()
        with collect_phases(phases):
            calls[what]()
        runs[what].append(((time.perf_counter() - t0) * 1e3, phases))
    names = ("host_prep", "upload", "device", "lloyd_sync", "readback", "unpack")
    emit({"phase": "timing", "what": "reduce 16 frames of 1920x1080 at k=8 replace, e2e: "
          "reduce_images against 16 sequential reduce calls, in turns", "card": card,
          "ms_each": {w: [r[0] for r in v] for w, v in runs.items()},
          "median_ms": {w: statistics.median(r[0] for r in v) for w, v in runs.items()},
          "frames_per_s": {w: N_FRAMES * 1e3 / statistics.median(r[0] for r in v)
                           for w, v in runs.items()},
          "phases_ms": {w: {n: statistics.median(r[1].get(n, 0.0) for r in v) * 1e3
                            for n in names} for w, v in runs.items()}})
    for what, call in calls.items():
        emit(profile_call(call, card, f"{what}, 16 frames of 1920x1080 k=8 replace"))
    return out


# --- This slice: TF32 settings, frames past the grid limit, the threshold
# kernel, and the two experiment tools (B9, B10) -----------------------------

TF32_APIS = ("allow_tf32", "fp32_precision")
TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores
THRESHOLD_KS = (1, 2, 3, 8, 257, 1024, 2048)
GRID_FRAMES = 65_537  # past the 65,535 frames one grid's y extent holds
MXU_RAGGED = (61, 97, 100)
# Float32 operations of one pixel into the factorized features: 33 into
# Lab (as `assign_bound`) and `PIXEL_OPS["factor"]`.
FEATURE_OPS = 33 + PIXEL_OPS["factor"]


def matmul_flags() -> dict:
    """Every matmul-precision read torch offers; a read that raises (the
    two APIs mixed) is recorded as such."""
    import torch

    m = torch.backends.cuda.matmul
    reads = {"precision": torch.get_float32_matmul_precision,
             "allow_tf32": lambda: m.allow_tf32}
    if hasattr(m, "fp32_precision"):
        reads["fp32_precision"] = lambda: m.fp32_precision
    flags = {}
    for name, read in reads.items():
        try:
            flags[name] = read()
        except RuntimeError:
            flags[name] = "raises"
    return flags


def set_tf32(how: str):
    """Turn TF32 matmuls on through `how` (one of `TF32_APIS`); return a
    callable that restores the previous setting exactly: the legacy flag
    by the legacy API, then the new API's value."""
    import torch

    m = torch.backends.cuda.matmul
    new_api = hasattr(m, "fp32_precision")
    if how == "fp32_precision" and not new_api:
        raise AssertionError(f"torch {torch.__version__} has no fp32_precision API")
    saved_new = m.fp32_precision if new_api else None
    saved_legacy = m.allow_tf32 if how == "allow_tf32" else None

    def restore():
        if how == "allow_tf32":
            m.allow_tf32 = saved_legacy
        if new_api:
            m.fp32_precision = saved_new

    if how == "allow_tf32":
        m.allow_tf32 = True
    else:
        m.fp32_precision = "tf32"
    return restore


def tf32_training(image) -> None:
    """C.1: `reduce(8)` on the 4K image (the shrunk trainer),
    `reduce_images` on 3 frames (the batched trainer) and a k=600 palette
    of a 640x600 image at full resolution (384,000 x 600 elements, past
    the 192M-element gate: the plain row-chunked trainer), each run with
    TF32 off, then on through each API: the outputs must be equal and the
    caller's flags must read back unchanged."""
    from kmeans_tpu_torch import ImageProcessor

    frames = [synthetic_image(150, 210, seed=SEED + 30 + f) for f in range(3)]
    mid = synthetic_image(600, 640, seed=SEED + 33)
    proc = ImageProcessor(device="cuda")
    full = ImageProcessor(device="cuda", train_max_size=None)

    def run():
        return ([proc.reduce(K, image).pixels]
                + [r.pixels for r in proc.reduce_images(frames, K)]
                + [full.palette(600, mid)])

    before = matmul_flags()
    want = run()
    for how in TF32_APIS:
        restore = set_tf32(how)
        try:
            during = matmul_flags()
            got = run()
        finally:
            restore()
        after = matmul_flags()
        equal = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
        line = {"phase": "tf32_training", "api": how, "outputs_equal": equal,
                "flags_before": before, "flags_during": during, "flags_after": after}
        emit(line)
        if not all(equal) or after != before or during == before:
            raise AssertionError(f"tf32_training: {line}")


def frames_past_grid_limit(device) -> None:
    """C.2: `assign_frames_packed` (dither) and `meld_frames_packed` on
    65,537 frames of 4x4 pixels, distinct palettes and `k_actives`, k=8:
    the words of one call against the same kernels launched on frames
    [0, 65535) and [65535, 65537) apart, and against the twins on frames
    0, 65534, 65535 and 65536."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.quantize import dither_thresholds

    rng = np.random.default_rng(SEED + 40)
    b = GRID_FRAMES
    frames = torch.from_numpy(rng.integers(0, 256, (b, 4, 4, 3), dtype=np.uint8)).to(device)
    pal = torch.from_numpy(rng.integers(0, 256, (b, K, 3), dtype=np.uint8)).to(device)
    cents = srgb8_to_lab(pal).contiguous()
    k_actives = [1 + f % K for f in range(b)]
    thr = dither_thresholds(cents, k_actives)
    for form in ("packed", "meld"):
        def run(sl, form=form):
            if form == "meld":
                return kernels.meld_frames_packed(frames[sl], cents[sl], k_actives[sl])
            return kernels.assign_frames_packed(frames[sl], cents[sl], thr[sl], k_actives[sl],
                                                mode="dither")

        whole = run(slice(None))  # each frame pads to a 32,768-pixel tile
        split = [bool(torch.equal(whole[:65_535], run(slice(0, 65_535)))),
                 bool(torch.equal(whole[65_535:], run(slice(65_535, None))))]
        twins = []
        for f in (0, 65_534, 65_535, 65_536):
            if form == "meld":
                want = kernels.meld_packed_reference(frames[f], cents[f], k_actives[f])
            else:
                want = kernels.assign_packed_reference(frames[f], cents[f], thr[f],
                                                       k_actives[f], mode="dither")
            twins.append(bool(torch.equal(whole[f], want.reshape(whole[f].shape))))
        torch.cuda.synchronize()
        line = {"phase": "frames_past_grid_limit", "form": form, "frames": b,
                "equal_to_split_launches": split, "equal_to_twins_at_0_65534_65535_65536": twins}
        emit(line)
        del whole
        if not all(split + twins):
            raise AssertionError(f"frames past the grid limit: {line}")


def _events_ms(fn) -> float:
    """Milliseconds of one call of `fn` by CUDA events (no warm-up: for
    the plain loops that take seconds)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def dither_threshold_vs_plain(device, image, card) -> dict:
    """C.3: the threshold kernel against its twin at every k of
    `THRESHOLD_KS`, both metrics, one palette and B = 3 palettes with
    per-frame `k_active` (B = 3 up to k = 1024): equal bits. The plain
    loop's time is that of its checked run (one call); the kernel's the
    mean of 20 warm launches. Then `reduce(2048)` dither against replace
    end to end, in turns. Returns the k=2048 CIE94 times for the kernels
    line."""
    import torch

    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.ops.quantize import (
        dither_threshold,
        dither_threshold_reference,
        dither_thresholds,
        dither_thresholds_reference,
    )

    failures, times = [], {}
    for metric in ("cie94", "cie2000"):
        for k in THRESHOLD_KS:
            cents = random_palette_lab(k, SEED + 50 + k, device)
            got = dither_threshold(cents, metric=metric)
            plain_ms = _events_ms(lambda: dither_threshold_reference(cents, metric=metric))
            want = dither_threshold_reference(cents, metric=metric)
            equal = bool(got.view(torch.int32) == want.view(torch.int32))
            line = {"phase": "dither_threshold_vs_plain", "k": k, "metric": metric,
                    "frames": 1, "equal_bits": equal, "threshold": float(got)}
            if k >= 1024:
                kernel_ms = cuda_ms(lambda: dither_threshold(cents, metric=metric), 20)
                times[metric, k] = (kernel_ms, plain_ms)
                line.update({"card": card, "kernel_ms": kernel_ms, "plain_ms": plain_ms})
            if k <= 1024:
                pals = torch.stack([random_palette_lab(k, SEED + 60 + k + f, device)
                                    for f in range(3)])
                k_actives = [k, max(1, k // 2), max(1, k - 1)]
                g = dither_thresholds(pals, k_actives, metric)
                w = dither_thresholds_reference(pals, k_actives, metric)
                line["frames_equal_bits"] = bool(torch.equal(g.view(torch.int32),
                                                             w.view(torch.int32)))
                line["k_actives"] = k_actives
                equal = equal and line["frames_equal_bits"]
            emit(line)
            if not equal:
                failures.append(f"dither_threshold k={k} {metric}")
    if failures:
        raise AssertionError("; ".join(failures))
    proc = ImageProcessor(device="cuda")
    for line in timed_reduces({
        "reduce 3840x2160 k=2048 replace, median of 2 warm": (proc, ReduceMode.REPLACE),
        "reduce 3840x2160 k=2048 dither, median of 2 warm": (proc, ReduceMode.DITHER),
    }, image, card, k=2048, rounds=3):
        emit(line)
    kernel_ms, plain_ms = times["cie94", 2048]
    # One thread reads the palette once and writes one float; the walk is
    # two distances and a square root per centroid.
    bound = _bound(2048 * 12 + 4, 2 * 2046 * (METRIC_OPS["cie94"] + 1) + 2)
    return {"times": (kernel_ms, plain_ms, *bound), "err": 0}


def exp_mxu_vs_plain(device, card) -> dict:
    """B9 through its entry point, the tool `kmeans_tpu_torch.tools.exp_mxu`:
    its evaluation pass (one launch of each kernel at k = 64 and 256 on the
    seeded 3840x2160 image) with the counts set to 0 just before it; then,
    on the same data and on a ragged 61x97 k=100 case, factor-vpu against
    its twin (0 differing indices) and `assign_u8(fast=True)`, factor-mxu
    against its TF32 twin (each flip a near-tie); the kernels' and the
    twins' times beside `argmin(feats @ G)` with TF32 off and on; then the
    tool's own timing lines. Returns the k=64 figures for the kernels
    line."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.tools import exp_mxu

    reset_launch_counts()
    tool_lines = exp_mxu.measure(device, smoke=False, reps=0)
    torch.cuda.synchronize()
    counts = mode_counts()
    ks = exp_mxu.KS
    want = {"exp_factor_vpu cie94 factor": len(ks), "exp_factor_mxu cie94 tf32": len(ks),
            "assign_u8 cie94 exact": len(ks), "assign_u8 cie94 factor": len(ks)}
    emit({"phase": "exp_mxu_vs_plain", "tool_launches": counts,
          "mismatch_frac_vs_exact": {f"{line['variant']} k={line['k']}":
                                     line["mismatch_frac_vs_exact"] for line in tool_lines}})
    if counts != want:
        raise AssertionError(f"exp_mxu launches {counts}, want {want}")

    rng = np.random.default_rng(0)  # the tool's data, drawn in its order
    img = torch.from_numpy(exp_mxu.random_image(HEIGHT, WIDTH, rng)).to(device)
    cases = [(img, torch.from_numpy(exp_mxu.random_centroids(kp, rng)).to(device))
             for kp in ks]
    rng = np.random.default_rng(SEED + 70)
    h, w, kp = MXU_RAGGED
    cases.append((torch.from_numpy(exp_mxu.random_image(h, w, rng)).to(device),
                  torch.from_numpy(exp_mxu.random_centroids(kp, rng)).to(device)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out, failures = {}, []
    for img_c, cents in cases:
        h, w, kp = img_c.shape[0], img_c.shape[1], cents.shape[0]
        vpu = exp_mxu.factor_vpu(img_c, cents)
        vpu_plain = exp_mxu.factor_vpu_reference(img_c, cents)
        fast = kernels.assign_u8(img_c[..., :3].contiguous(), cents, 0.0, fast=True)
        mxu = exp_mxu.factor_mxu(img_c, cents)
        mxu_plain = exp_mxu.factor_mxu_reference(img_c, cents, tf32=True)
        flips, near = exp_mxu.near_ties(img_c, cents, mxu, mxu_plain, tf32=True)
        line = {"phase": "exp_mxu_vs_plain", "h": h, "w": w, "k": kp,
                "vpu_differing_vs_twin": int((vpu != vpu_plain).sum()),
                "vpu_differing_vs_assign_u8_fast": int((vpu != fast).sum()),
                "mxu_flips_vs_tf32_twin": flips, "mxu_flips_are_near_ties": near,
                "vpu_max_abs_index_diff": int((vpu.int() - vpu_plain.int()).abs().max()),
                "mxu_max_abs_index_diff": int((mxu.int() - mxu_plain.int()).abs().max())}
        if (h, w) == (HEIGHT, WIDTH):
            n = h * w
            feats, gmat = exp_mxu.mxu_operands(img_c, cents, tf32=False)
            library = {"off": cuda_ms(lambda: torch.argmin(feats @ gmat, dim=1), 10, flush)}
            restore = set_tf32("allow_tf32")
            try:
                library["on"] = cuda_ms(lambda: torch.argmin(feats @ gmat, dim=1), 10, flush)
            finally:
                restore()
            del feats, gmat
            vpu_bound = _bound(5 * n, n * (FEATURE_OPS + SCREEN_OPS * kp))
            t_bytes = 5 * n / HBM_BYTES_PER_S * 1e3
            t_tensor = n * kp * 16 / TF32_OPS_PER_S * 1e3
            t_cuda = n * (FEATURE_OPS + 2 * kp) / F32_OPS_PER_S * 1e3
            # The larger of the bytes' time and the two units' times; the
            # tensor cores and the CUDA cores run side by side.
            mxu_bound = (max(t_bytes, t_tensor, t_cuda),
                         "bytes" if t_bytes >= max(t_tensor, t_cuda) else "operations")
            timing = {
                "vpu": (cuda_ms(lambda: exp_mxu.factor_vpu(img_c, cents), 10, flush),
                        cuda_ms(lambda: exp_mxu.factor_vpu_reference(img_c, cents), 2, flush),
                        *vpu_bound),
                "mxu": (cuda_ms(lambda: exp_mxu.factor_mxu(img_c, cents), 10, flush),
                        cuda_ms(lambda: exp_mxu.factor_mxu_reference(img_c, cents), 2, flush),
                        *mxu_bound),
            }
            line.update({"card": card, "vpu_ms": timing["vpu"][0], "vpu_plain_ms": timing["vpu"][1],
                         "vpu_bound_ms": timing["vpu"][2], "mxu_ms": timing["mxu"][0],
                         "mxu_plain_ms": timing["mxu"][1], "mxu_bound_ms": timing["mxu"][2],
                         "mxu_bound_by": timing["mxu"][3], "mxu_bound_parts_ms": {
                             "bytes": t_bytes, "tensor_tf32": t_tensor,
                             "cuda_core_features_compare_select": t_cuda},
                         "library_argmin_matmul_ms_tf32_off": library["off"],
                         "library_argmin_matmul_ms_tf32_on": library["on"]})
            out[kp] = {"timing": timing, "library": library,
                       "err": (line["vpu_max_abs_index_diff"], line["mxu_max_abs_index_diff"])}
        emit(line)
        if line["vpu_differing_vs_twin"] or line["vpu_differing_vs_assign_u8_fast"] or not near:
            failures.append(f"exp_mxu {h}x{w} k={kp}: {line}")
    if failures:
        raise AssertionError("; ".join(failures))
    del flush
    for line in exp_mxu.measure(device, smoke=False, reps=10):
        emit({"phase": "timing", "what": "exp_mxu tool", "card": card, **line})
    return {"counts": counts, **out}


def exp_gather_vs_plain(device, card) -> dict:
    """B10 through its entry point, the tool
    `kmeans_tpu_torch.tools.exp_gather`: its evaluation pass (each table
    placement once for the gather and once for the sum of 8 reads, the pow
    sum once) with the counts set to 0 just before it; every placement
    must return the table's bits; the lut sums against their twin (equal
    bits), the pow sum against its twin (bits, or ulps counted), `powf`'s
    table against numpy's; the kernels' and twins' times beside
    `torch.take` for the gather; then the tool's own timing lines."""
    import torch

    from kmeans_tpu_torch.tools import exp_gather as eg

    reset_launch_counts()
    tool_lines = eg.measure(device, reps=0)
    torch.cuda.synchronize()
    counts = mode_counts()
    want = {f"exp_gather {p} table": 1 for p in eg.PLACEMENTS}
    want.update({f"exp_lut {p} table": 1 for p in eg.PLACEMENTS})
    want.update({"exp_pow - powf": 1, "exp_pow_table - powf": 1})
    correct = {line["form"]: line["correct"] for line in tool_lines if "form" in line}
    pow_table = next(line for line in tool_lines if "pow_table_vs_numpy" in line)
    table = eg.gamma_table(device)
    idx = torch.from_numpy(eg.gather_indices()).to(device)
    grid = torch.from_numpy(eg.grid_indices(np.random.default_rng(3))).to(device)
    lut_plain = eg.lut_sum_reference(table, grid)
    lut_equal = {p: bool(torch.equal(eg.lut_sum(table, grid, p).view(torch.int32),
                                     lut_plain.view(torch.int32))) for p in eg.PLACEMENTS}
    pow_k, pow_plain = eg.pow_sum(grid), eg.pow_sum_reference(grid)
    ulps = eg.ulps(pow_k, pow_plain)
    table_ulps = eg.ulps(eg.pow_table(device), eg.pow_table_reference(device))
    line = {"phase": "exp_gather_vs_plain", "tool_launches": counts, "correct": correct,
            "lut_equal_bits": lut_equal, "pow_sums_differing": int((ulps > 0).sum()),
            "pow_max_ulps": int(ulps.max()),
            "pow_max_abs_err": float((pow_k - pow_plain).abs().max()),
            "pow_table_vs_twin_max_ulps": int(table_ulps.max()), **pow_table}
    emit(line)
    if counts != want or not all(correct.values()) or not all(lut_equal.values()) \
            or int(ulps.max()) > 8 or int(table_ulps.max()) > 8:
        raise AssertionError(f"exp_gather: {line} (launches wanted {want})")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    n_small, n_grid = idx.numel(), grid.numel()
    timing = {}
    for p in eg.PLACEMENTS:
        timing["gather", p] = (cuda_ms(lambda p=p: eg.gather(table, idx, p), 50, flush),
                               cuda_ms(lambda: eg.gather_reference(table, idx), 20, flush),
                               *_bound(8 * n_small + 1024, n_small))
        timing["lut", p] = (cuda_ms(lambda p=p: eg.lut_sum(table, grid, p), 20, flush),
                            cuda_ms(lambda: eg.lut_sum_reference(table, grid), 5, flush),
                            *_bound(8 * n_grid + 1024, 8 * n_grid))
    timing["pow"] = (cuda_ms(lambda: eg.pow_sum(grid), 20, flush),
                     cuda_ms(lambda: eg.pow_sum_reference(grid), 5, flush),
                     *_bound(8 * n_grid, 8 * 8 * n_grid))
    timing["pow_table"] = (cuda_ms(lambda: eg.pow_table(device), 50, flush),
                           cuda_ms(lambda: eg.pow_table_reference(device), 50, flush),
                           *_bound(4 * 256, 2 * 256))
    idx_long = idx.long()  # torch.take indexes by int64
    take_ms = cuda_ms(lambda: torch.take(table, idx_long), 50, flush)
    del flush
    emit({"phase": "timing", "what": "exp_gather kernels (cold L2, mean)", "card": card,
          "take_ms": take_ms,
          **{" ".join(key) if isinstance(key, tuple) else key: {
              "kernel_ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3]}
             for key, t in timing.items()}})
    for tline in eg.measure(device, reps=20):
        emit({"phase": "timing", "what": "exp_gather tool", "card": card, **tline})
    return {"counts": counts, "timing": timing, "take_ms": take_ms,
            "pow_err": line["pow_max_abs_err"], "pow_table_ulps": line["pow_table_vs_twin_max_ulps"]}


def update_cost(image, device, card) -> None:
    """C.1's cost: the shrunk training (256x144 of the 4K image) at k = 8
    and k = 2048 with the float64 one-hot product against the float32 one
    it replaced (full float32, TF32 off), in turns (f64, f32, f32, f64,
    three times over)."""
    import torch

    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.resize import resize_uint8

    def update_f32(pixels, assign, k):
        onehot = torch.zeros((pixels.shape[0], k), dtype=torch.float32,
                             device=pixels.device).scatter_(1, assign[:, None], 1.0)
        return onehot.T @ pixels, onehot.sum(dim=0)

    dev = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(device)
    work = srgb8_to_lab(resize_uint8(dev, 144, 256).reshape(-1, 3))
    first = km.reference_seed_index(256, 144)
    update_f64 = km._update_centroids
    for k in (K, 2048):
        runs = {"float64": [], "float32": []}
        for form in ("float64", "float32", "float32", "float64") * 3:
            km._update_centroids = update_f64 if form == "float64" else update_f32
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, iters = km.fit_restarts(work, k, first)
                torch.cuda.synchronize()
                runs[form].append(((time.perf_counter() - t0) * 1e3, iters))
            finally:
                km._update_centroids = update_f64
        emit({"phase": "timing", "what": f"shrunk training 256x144 k={k}: one-hot product "
              "in float64 against float32, in turns", "card": card,
              **{f"{form}_ms_iterations": r for form, r in runs.items()}})


# The exact tiers' register tiles, pixels a thread scans together
# (`exact_tile_pixels` in csrc/quantize_assign.cu, `kTilePixels` in
# csrc/lloyd_accumulate.cu; CIEDE2000 one at a time), to turn a centroid
# loop's length into instructions a pixel-centroid pair.
TILE_PIXELS = {"assign_exact_kernel<0": 2, "assign_exact_kernel<1": 1, "lloyd_tile_kernel<0,0": 8,
               "lloyd_tile_kernel<1,0": 1}
ADVERSARIAL = ("duplicates", "grey", "pixel_is_centroid", "inf", "tiny", "k_active")


# The design each kernel line runs. The exact tiers of the assign kernel
# (every output mode) and of the accumulator scan a register tile of
# pixels against 16-byte centroid loads, CIE94 dividing through hoisted
# reciprocals (CIEDE2000 one pixel at a time); the accumulator's tiers
# all sum by warp groups. The other kernels keep one thread a word.
TILED = {"assign_packed", "quantize_rgba", "quantize_rgba[chunked]", "assign_u8",
         "assign_frames_packed", "quantize_frames"}


def design_of(name: str) -> str:
    if name in TILED:
        return "register tile, hoisted reciprocals"
    if name == "assign_packed[cie2000]":
        return "one pixel a thread, 16-byte centroid loads"
    if name == "lloyd_accumulate":
        return "register tile, hoisted reciprocals, warp-group sums"
    if name.startswith("lloyd_accumulate"):
        return "one pixel at a time, warp-group sums"
    if name.startswith("exp_"):
        return "experiment tool"
    if name == "dither_threshold":
        return "one thread a palette"
    return "one thread a word"


def compiler_report(lib_path, ptxas) -> None:
    """`ptxas` lines (registers, stack and spill bytes of every instance of
    the assign and accumulator kernels, from `-Xptxas -v`) and `sass`
    lines (the exact instances' centroid loops in the built library: its
    instructions, per pixel-centroid pair, and by opcode). Fails on a
    spill in an exact assign instance or any accumulator instance (the
    kernels this design changed)."""
    from kmeans_tpu_torch.tools import sass

    spills = []
    for source, rows in ptxas.items():
        for row in rows:
            emit({"phase": "ptxas", "source": source, **row})
            if "exact" in row["kernel"] or row["kernel"].startswith("lloyd_tile_kernel<"):
                if row["spill_store_bytes"] or row["spill_load_bytes"]:
                    spills.append(row)
    for name, loop in sass.centroid_loops(lib_path).items():
        p = next((v for k, v in TILE_PIXELS.items() if name.startswith(k)), None)
        if loop is None or p is None:
            continue
        emit({"phase": "sass", "kernel": name, "loop_start": loop["start"],
              "instructions": loop["instructions"], "pixels_per_thread": p,
              "instructions_per_pair": loop["instructions"] / p, "opcodes": loop["opcodes"]})
    if spills:
        raise AssertionError(f"spills: {spills}")


def adversarial_case(case, k, seed, device, h=37, w=53):
    """(rgb, centroids, k_active) of one adversarial palette for the exact
    tiles (as `tests/test_torch_cuda.py::_adversarial`)."""
    import torch

    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if case in ("grey", "tiny"):
        rgb[..., 1] = rgb[..., 2] = rgb[..., 0]
    pal = rng.integers(0, 256, (k, 3), dtype=np.uint8)
    if case == "pixel_is_centroid":
        pal = rgb.reshape(-1, 3)[rng.choice(h * w, k, replace=False)]
    cents = srgb8_to_lab(torch.from_numpy(pal).to(device)).contiguous()
    if case == "duplicates" and k > 1:
        cents[k // 2:] = cents[: k - k // 2].clone()
    if case == "inf":
        cents[k // 2] = torch.tensor([np.inf, -np.inf, np.inf], device=device)
    if case == "tiny":
        cents[0] = torch.tensor([50.0, 1e-25, 0.0], device=device)
    return torch.from_numpy(rgb).to(device), cents, max(1, k - k // 3) if case == "k_active" else k


def exact_tile_checks(device) -> None:
    """`exact_tile_vs_plain`: the register-tiled exact kernels on
    adversarial palettes (duplicate centroids, grey pixels, centroids equal
    to pixels, a centroid at +-inf, a chroma of 1e-25 on grey pixels,
    `k_active < kp`) at k = 1, 8, 64, 512, both metrics: packed replace and
    dither, RGBA and u8 words equal to the twins'; the accumulator's counts
    equal and sums within 1e-5 of scale."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.quantize import dither_threshold

    failures = []
    for metric in ("cie94", "cie2000"):
        for k in (1, 8, 64, 512):
            for case in ADVERSARIAL:
                rgb, cents, k_active = adversarial_case(case, k, 4000 + k, device)
                finite = cents[torch.isfinite(cents).all(-1)]
                thr = dither_threshold(finite, metric=metric) if len(finite) else 0.0
                words = 0
                for mode in ("replace", "dither"):
                    args = (rgb, cents, thr, k_active, mode, 1, metric)
                    pairs = [(kernels.assign_packed, kernels.assign_packed_reference),
                             (kernels.quantize_rgba, kernels.quantize_rgba_reference)]
                    if k <= 256:
                        pairs.append((kernels.assign_u8, kernels.assign_u8_reference))
                    for call, twin in pairs:
                        words += int((call(*args) != twin(*args)).sum().item())
                planes, n = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
                acc = (planes, cents, n, k_active, None, metric, True)
                got, want = kernels.lloyd_accumulate(*acc), kernels.lloyd_accumulate_reference(*acc)
                torch.cuda.synchronize()
                # A centroid at +-inf takes no pixel but, with none nearer,
                # every pixel's kBig inertia: its row is held to counts only.
                rows = torch.isfinite(cents).all(-1) | (want[:, 3] == 0)
                bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
                sums_ok = bool(((got.double() - want.double()).abs() <= bound)[rows].all())
                line = {"phase": "exact_tile_vs_plain", "metric": metric, "k": k, "case": case,
                        "mismatched_words": words,
                        "counts_equal": bool(torch.equal(got[:, 3], want[:, 3])),
                        "sums_within_bar": sums_ok}
                emit(line)
                if words or not line["counts_equal"] or not sums_ok:
                    failures.append(f"exact_tile_vs_plain: {line}")
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import _lab_palette_to_u8, _unpack_gather
    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops import _build, kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.tools import _exp, sass

    device = torch.device("cuda", 0)
    card = card_line()

    # 1. Device.
    emit({
        "phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "count": torch.cuda.device_count(),
    })

    # 2. Build: the main library and the experiment tools' library, each
    # source in its own nvcc process, all started together.
    # Beside them, the assign and accumulator sources with `-Xptxas -v`.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        main_lib = pool.submit(_build.build)
        exp_lib = pool.submit(_exp.build_exp_library)
        reports = {src: pool.submit(sass.ptxas_report, _build.CSRC / src)
                   for src in ("quantize_assign.cu", "lloyd_accumulate.cu")}
        lib_path, exp_path = main_lib.result(), exp_lib.result()
        ptxas = {src: report.result() for src, report in reports.items()}
    _build.load_library()
    _exp.load_exp_library()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "library": lib_path.name, "exp_library": exp_path.name,
    })
    compiler_report(lib_path, ptxas)

    # 3. Kernel vs plain on the card: under CIE94 the words must be equal,
    # under CIEDE2000 every flip a near-tie.
    failures = []
    max_abs_err = {"cie94": 0, "cie2000": 0}
    cases = [(h, w, k, m, None, 0) for k in COMPARE_KS for (h, w) in RAGGED
             for m in ("replace", "dither")]
    cases += [
        (61, 97, 16, "dither", 11, 0),     # k_active < kp
        (61, 97, 257, "replace", 200, 0),  # k_active < kp, 16-bit tier
        (61, 97, 8, "dither", None, 3),    # row_offset
        (HEIGHT, WIDTH, K, "replace", None, 0),
        (HEIGHT, WIDTH, K, "dither", None, 0),
    ]
    cases = [case + ("cie94",) for case in cases]
    cases += [(h, w, k, m, None, 0, "cie2000") for k in COMPARE_KS_2000 for (h, w) in RAGGED
              for m in ("replace", "dither")]
    cases += [
        (61, 97, 1024, "replace", None, 0, "cie2000"),
        (61, 97, 16, "dither", 11, 3, "cie2000"),  # k_active < kp, row_offset
        (HEIGHT, WIDTH, K, "replace", None, 0, "cie2000"),
        (HEIGHT, WIDTH, K, "dither", None, 0, "cie2000"),
    ]
    for h, w, k, mode, k_active, row_offset, metric in cases:
        mism, err, flips, near_ties = compare_case(h, w, k, mode, device, k_active,
                                                   row_offset, metric=metric)
        max_abs_err[metric] = max(max_abs_err[metric], err)
        emit({
            "phase": "kernel_vs_plain", "h": h, "w": w, "k": k, "mode": mode,
            "k_active": k_active, "row_offset": row_offset, "metric": metric,
            "mismatched_words": mism, "max_abs_index_diff": err,
            "flipped_indices": flips, "flips_are_near_ties": near_ties,
        })
        if mism if metric == "cie94" else not near_ties:
            failures.append(f"kernel_vs_plain {h}x{w} k={k} {mode} {metric}: "
                            f"{mism} words differ, near-ties {near_ties}")
    if failures:
        raise AssertionError("; ".join(failures))

    # 3a. The meld kernel vs plain on the card.
    meld_cases = [(h, w, k, metric, k == 8) for metric in ("cie94", "cie2000")
                  for k in MELD_KS for (h, w) in RAGGED]
    meld_cases += [(HEIGHT, WIDTH, K, "cie94", False), (HEIGHT, WIDTH, K, "cie2000", False)]
    meld_err = {"cie94": 0, "cie2000": 0}
    for h, w, k, metric, repeat in meld_cases:
        line = meld_case(h, w, k, metric, device, repeat)
        emit(line)
        meld_err[metric] = max(meld_err[metric], line["max_channel_step"])
        if not meld_ok(line):
            failures.append(f"meld_kernel_vs_plain: {line}")
    if failures:
        raise AssertionError("; ".join(failures))

    # 3b. The accumulator kernel vs plain on the card.
    image = synthetic_image(HEIGHT, WIDTH)
    lab_4k = srgb8_to_lab(torch.from_numpy(
        np.ascontiguousarray(image[..., :3]).reshape(-1, 3)).to(device))
    accum_cases = [(random_lab(ACCUM_PIXELS, SEED + k, device), k, {}) for k in ACCUM_KS]
    small_lab = random_lab(ACCUM_PIXELS, SEED + 1000, device)
    accum_cases += [
        (small_lab, 17, {"k_active": 11, "weighted": True, "inertia": True}),
        (small_lab, 256, {"k_active": 200, "inertia": True, "bf16": True}),
        (small_lab, 64, {"bf16": True}),
        (small_lab, 8, {"weighted": True}),
        (small_lab, 512, {"inertia": True}),
        (lab_4k, K, {}),
        (lab_4k, K, {"inertia": True, "bf16": True}),
    ]
    accum_cases += [(random_lab(ACCUM_PIXELS, SEED + 2000 + k, device), k, {"metric": "cie2000"})
                    for k in (1, 8, 17, 65, 512)]
    accum_cases += [
        (small_lab, 17, {"k_active": 11, "weighted": True, "inertia": True, "metric": "cie2000"}),
        (small_lab, 64, {"inertia": True, "bf16": True, "metric": "cie2000"}),
        (lab_4k, K, {"metric": "cie2000"}),
    ]
    accum_err = {"cie94": 0.0, "cie2000": 0.0}
    for lab, k, opts in accum_cases:
        line = accum_case(lab, k, device, **opts)
        emit(line)
        accum_err[line["metric"]] = max(accum_err[line["metric"]], line["max_abs_err"])
        if not (line["counts_equal"] and line["deterministic"]
                and line["max_err_over_scale"] <= 1e-5):
            failures.append(f"lloyd_kernel_vs_plain k={k} {opts}: {line}")
    if failures:
        raise AssertionError("; ".join(failures))
    exact_tile_checks(device)

    # 4. The slice, through the entry points a user calls.
    proc = ImageProcessor(device="cuda")
    rng = np.random.default_rng(SEED + 1)
    find_colors = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    find_colors[:, 3] = 255

    kernels.LAUNCHES_BY_MODE.clear()
    counts = []
    out_replace = proc.reduce(K, image, reduce_mode=ReduceMode.REPLACE)
    iters_replace = proc.last_iterations
    counts.append(kernels.launches("assign_packed"))
    out_dither = proc.reduce(K, image, reduce_mode=ReduceMode.DITHER)
    counts.append(kernels.launches("assign_packed"))
    pal = proc.palette(K, image)
    counts.append(kernels.launches("assign_packed"))
    out_find = proc.find(image, find_colors, ReduceMode.DITHER)
    counts.append(kernels.launches("assign_packed"))
    torch.cuda.synchronize()
    launches = kernels.launches("assign_packed")
    threshold_launches = kernels.launches("dither_threshold")
    # One launch per reduce and per find; palette trains only, and the
    # 256x144 shrink trains on the one-hot trainer. Each dither call takes
    # its threshold from one launch of the threshold kernel.
    if counts != [1, 2, 2, 3]:
        raise AssertionError(f"assign kernel launch counts {counts}, expected [1, 2, 2, 3]")
    if threshold_launches != 2:
        raise AssertionError(f"threshold kernel launches {threshold_launches}, expected 2")
    if kernels.launches("lloyd_accumulate") != 0:
        raise AssertionError("the shrunk training launched the accumulator")

    for name, out, k in (("reduce_replace", out_replace, K),
                         ("reduce_dither", out_dither, K),
                         ("find_dither", out_find, 16)):
        px = out.pixels
        n_colors = len(unique_rgba(px))
        if px.shape != (HEIGHT, WIDTH, 4) or n_colors > k or not (px[..., 3] == 255).all():
            raise AssertionError(f"{name}: shape {px.shape}, {n_colors} colours")
        emit({"phase": "slice", "call": name, "colors": n_colors})

    # Each reduce against the plain version's indices for the same palette.
    dev = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(device)
    cents = proc.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    pal_np = _lab_palette_to_u8(cents)[0].cpu().numpy()
    for mode, out in (("replace", out_replace), ("dither", out_dither)):
        thr = dither_threshold(cents) if mode == "dither" else 0.0
        words = kernels.assign_packed_reference(dev, cents, thr, mode=mode)
        plain = _unpack_gather(words.cpu().numpy(), HEIGHT, WIDTH, K, pal_np)
        differ = int((plain != out.pixels).any(axis=-1).sum())
        emit({"phase": "slice_vs_plain", "mode": mode, "differing_pixels": differ})
        if differ:
            raise AssertionError(f"reduce {mode}: {differ} pixels differ from plain")
    emit({
        "phase": "slice", "iterations": iters_replace,
        "palette": ["#%02X%02X%02X" % tuple(c[:3]) for c in pal],
        "assign_launches": launches, "dither_threshold_launches": threshold_launches,
    })

    # The card against the CPU on a small input.
    small = synthetic_image(300, 420, seed=SEED + 2)
    cpu_proc = ImageProcessor(device="cpu")
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER):
        on_card = proc.reduce(K, small, reduce_mode=mode).pixels
        on_cpu = cpu_proc.reduce(K, small, reduce_mode=mode).pixels
        differ = int((on_card != on_cpu).any(axis=-1).sum())
        same_palette = bool(
            (proc.palette(K, small) == cpu_proc.palette(K, small)).all()
        )
        emit({"phase": "card_vs_cpu", "mode": mode.value, "differing_pixels": differ,
              "pixels": 300 * 420, "same_palette": same_palette})
        if not same_palette or differ > 300 * 420 // 10000:
            raise AssertionError(f"card vs cpu {mode.value}: {differ} pixels differ")

    # 4b. The full-resolution slice: every training runs on all 8,294,400
    # pixels through the accumulator kernel.
    full = ImageProcessor(device="cuda", train_max_size=None)
    full_r2 = ImageProcessor(device="cuda", train_max_size=None, restarts=2)
    kernels.LAUNCHES_BY_MODE.clear()
    steps = []
    t0 = time.perf_counter()
    out_full = full.reduce(K, image, reduce_mode=ReduceMode.REPLACE)
    steps.append(("reduce k=8", full.last_iterations, time.perf_counter() - t0))
    t0 = time.perf_counter()
    pal_full = full.palette(K, image)
    steps.append(("palette k=8", full.last_iterations, time.perf_counter() - t0))
    t0 = time.perf_counter()
    pal_256 = full.palette(256, image)
    steps.append(("palette k=256", full.last_iterations, time.perf_counter() - t0))
    t0 = time.perf_counter()
    pal_r2 = full_r2.palette(K, image)
    steps.append(("palette k=8 restarts=2", full_r2.last_iterations, time.perf_counter() - t0))
    torch.cuda.synchronize()
    full_launches = kernels.launches("lloyd_accumulate")
    full_assign = kernels.launches("assign_packed")
    # The winner's iterations alone do not give the restarts' launches:
    # rerun each seed (outside the counted path) for its iteration count.
    seeds = km.derive_restart_seeds(HEIGHT * WIDTH, km.reference_seed_index(WIDTH, HEIGHT), 2)
    restart_iters = [km.fit_large(lab_4k, K, s)[1] for s in seeds.tolist()]
    want_launches = steps[0][1] + steps[1][1] + steps[2][1] + sum(restart_iters) + 2
    for name, iters, secs in steps:
        emit({"phase": "full_res_slice", "call": name, "iterations": iters, "seconds": secs})
    px = out_full.pixels
    n_colors = len(unique_rgba(px))
    emit({
        "phase": "full_res_slice", "reduce_colors": n_colors,
        "palette_k8": ["#%02X%02X%02X" % tuple(c[:3]) for c in pal_full],
        "palette_k8_restarts2": ["#%02X%02X%02X" % tuple(c[:3]) for c in pal_r2],
        "palette_k256_rows": int(pal_256.shape[0]), "restart_iterations": restart_iters,
        "lloyd_launches": full_launches, "lloyd_launches_expected": want_launches,
        "assign_launches": full_assign,
    })
    if px.shape != (HEIGHT, WIDTH, 4) or n_colors > K or not (px[..., 3] == 255).all():
        raise AssertionError(f"full-resolution reduce: shape {px.shape}, {n_colors} colours")
    if pal_256.shape != (256, 4) or pal_full.shape != (K, 4) or pal_r2.shape != (K, 4):
        raise AssertionError("full-resolution palettes have the wrong shape")
    if full_launches != want_launches or full_assign != 1:
        raise AssertionError(
            f"accumulator launches {full_launches} (want {want_launches}), "
            f"assign launches {full_assign} (want 1)"
        )

    # 4c. Full-resolution training on the card against the CPU (the
    # accumulator kernel against its twin, 1,200,000 pixels > the gate).
    mid = synthetic_image(1000, 1200, seed=SEED + 3)
    cpu_full = ImageProcessor(device="cpu", train_max_size=None)
    card_pal, cpu_pal = full.palette(K, mid), cpu_full.palette(K, mid)
    iters_card_cpu = (full.last_iterations, cpu_full.last_iterations)
    on_card = full.reduce(K, mid).pixels
    on_cpu = cpu_full.reduce(K, mid).pixels
    differ = int((on_card != on_cpu).any(axis=-1).sum())
    same_palette = bool((card_pal == cpu_pal).all())
    emit({"phase": "card_vs_cpu_full_res", "pixels": 1000 * 1200,
          "same_palette": same_palette, "differing_pixels": differ,
          "iterations_card_cpu": iters_card_cpu})
    if not same_palette or differ > 1000 * 1200 // 10000:
        raise AssertionError(f"full-resolution card vs cpu: palette equal {same_palette}, "
                             f"{differ} pixels differ")

    # 4d. The meld slice and the CIEDE2000 slices, each driven with the
    # launch counts set to 0 just before it and read just after.
    meld_slice = drive_meld_and_cie2000(proc, image, find_colors, dev, device)
    cpu_2000 = ImageProcessor(device="cpu", delta_e="2000")
    proc2000 = meld_slice["proc2000"]
    for name, card_proc, cpu_p, mode in (
        ("meld", proc, cpu_proc, ReduceMode.MELD),
        ("meld delta_e=2000", proc2000, cpu_2000, ReduceMode.MELD),
        ("replace delta_e=2000", proc2000, cpu_2000, ReduceMode.REPLACE),
        ("dither delta_e=2000", proc2000, cpu_2000, ReduceMode.DITHER),
    ):
        step = np.abs(card_proc.reduce(K, small, reduce_mode=mode).pixels.astype(np.int64)
                      - cpu_p.reduce(K, small, reduce_mode=mode).pixels).max(-1)
        same_palette = bool((card_proc.palette(K, small) == cpu_p.palette(K, small)).all())
        differ = int((step > 0).sum())
        emit({"phase": "card_vs_cpu", "mode": name, "differing_pixels": differ,
              "max_channel_step": int(step.max()), "pixels": 300 * 420,
              "same_palette": same_palette})
        # A meld blend uses the float centroids, whose last bits differ
        # between the card's and the CPU's training sums, and the two
        # devices' powf, atan2, sin and cos differ by an ulp here and there:
        # 1 u8 step on at most 1e-3 of the pixels, as against the JAX
        # package (tests/test_torch_meld.py). Replace and dither: 1e-4.
        bar = 1e-3 if mode is ReduceMode.MELD else 1e-4
        if not same_palette or differ > bar * 300 * 420 or step.max() > 1:
            raise AssertionError(f"card vs cpu {name}: {differ} pixels differ")

    # 4e. The fast slice: the six new kernel modes against plain, the 4K
    # paths at k = 64 and 256, what the fast modes move against the exact
    # kernels, and the card against the CPU.
    fast_err = fast_kernel_checks(device, lab_4k, small_lab)
    fast = drive_fast(image, dev, device, lab_4k)
    trained = [
        ("trained", "cie94", fast["cents"]["cie94"]),
        ("trained", "cie94", full.extract_palette_kmeans(Image((WIDTH, HEIGHT), image),
                                                         FAST_K_LARGE)),
        ("trained", "cie2000", fast["cents"]["cie2000"]),
        ("trained", "cie2000", fast["cents"]["full cie2000 256"]),
    ]
    fast_vs_exact(dev, lab_4k, trained + [
        ("random", metric, random_palette_lab(k, SEED + k, device))
        for metric in ("cie94", "cie2000") for k in (FAST_K, FAST_K_LARGE)])
    tiny = synthetic_image(150, 210, seed=SEED + 4)
    for delta_e in ("94", "2000"):
        card_p = ImageProcessor(device="cuda", fast=True, delta_e=delta_e)
        cpu_p = ImageProcessor(device="cpu", fast=True, delta_e=delta_e)
        same_palette = bool((card_p.palette(24, tiny) == cpu_p.palette(24, tiny)).all())
        for mode in (ReduceMode.REPLACE, ReduceMode.MELD):
            step = np.abs(card_p.reduce(24, tiny, reduce_mode=mode).pixels.astype(np.int64)
                          - cpu_p.reduce(24, tiny, reduce_mode=mode).pixels).max(-1)
            differ, over = int((step > 0).sum()), int((step > 1).sum())
            emit({"phase": "card_vs_cpu", "mode": f"fast k=24 {mode.value} delta_e={delta_e}",
                  "differing_pixels": differ, "over_1_step": over, "pixels": 150 * 210,
                  "same_palette": same_palette})
            # The fast tiers' bar: 1e-3 of the pixels (for meld: by more
            # than 1 u8 step).
            moved = over if mode is ReduceMode.MELD else differ
            if not same_palette or moved > 1e-3 * 150 * 210:
                raise AssertionError(f"card vs cpu fast {mode.value} delta_e={delta_e}: "
                                     f"{differ} pixels differ, {over} by more than 1 step")

    # 4f. Frame batching and palettes past 1024 colours: the frames and
    # colour-out kernel modes against plain, the slice at full width (each
    # path with its launches), its outputs against plain, and the card
    # against the CPU.
    frames_err = frames_kernel_checks(device)
    colour_err = colour_out_checks(device)
    frames = frames_rgba(SEED + 10)
    drive = drive_frames(image, frames, device)
    frames_plain = frames_slice_vs_plain(image, frames, device, drive)
    frames_card_vs_cpu()

    # 4g. This slice: training under TF32 settings (C.1), frames past the
    # grid limit (C.2), the threshold kernel against its twin and its times
    # (C.3), and the experiment tools through their entry points, their
    # kernels against their twins (B9, B10).
    tf32_training(image)
    frames_past_grid_limit(device)
    threshold = dither_threshold_vs_plain(device, image, card)
    mxu = exp_mxu_vs_plain(device, card)
    gather = exp_gather_vs_plain(device, card)

    # 5. Times: the shrunk and the full-resolution reduce, meld and
    # CIEDE2000 in turns.
    shrunk_timing, full_timing, meld_timing, timing_2000 = timed_reduces({
        "reduce 3840x2160 k=8 replace, median of 5 warm": (proc, ReduceMode.REPLACE),
        "full-resolution reduce 3840x2160 k=8 replace, median of 5 warm":
            (full, ReduceMode.REPLACE),
        "reduce 3840x2160 k=8 meld, median of 5 warm": (proc, ReduceMode.MELD),
        "reduce 3840x2160 k=8 replace delta_e=2000, median of 5 warm":
            (proc2000, ReduceMode.REPLACE),
    }, image, card)
    full_timing["accumulator_launches_per_reduce"] = full.last_iterations
    for line in (shrunk_timing, full_timing, meld_timing, timing_2000):
        emit(line)
    # The fast reduces at k = 64 in turns with the exact ones.
    for line in timed_reduces({
        f"reduce 3840x2160 k={FAST_K} replace, median of 3 warm": (proc, ReduceMode.REPLACE),
        f"reduce 3840x2160 k={FAST_K} replace fast=True, median of 3 warm":
            (ImageProcessor(device="cuda", fast=True), ReduceMode.REPLACE),
        f"reduce 3840x2160 k={FAST_K} replace delta_e=2000, median of 3 warm":
            (proc2000, ReduceMode.REPLACE),
        f"reduce 3840x2160 k={FAST_K} replace delta_e=2000 fast=True, median of 3 warm":
            (ImageProcessor(device="cuda", fast=True, delta_e="2000"), ReduceMode.REPLACE),
    }, image, card, k=FAST_K, rounds=4):
        emit(line)
    emit(profile_call(lambda: proc.reduce(K, image), card, "reduce 3840x2160 k=8 replace"))
    emit(profile_call(lambda: full.reduce(K, image), card,
                      "full-resolution reduce 3840x2160 k=8 replace"))

    timings = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for mode in ("replace", "dither"):
        thr = dither_threshold(cents) if mode == "dither" else torch.zeros((), device=device)

        def kernel():
            kernels.assign_packed(dev, cents, thr, mode=mode)

        def plain():
            kernels.assign_packed_reference(dev, cents, thr, mode=mode)

        k_ms, p_ms = cuda_ms(kernel, 20, flush), cuda_ms(plain, 5, flush)
        timings[mode] = (k_ms, p_ms)
        emit({
            "phase": "timing", "what": f"assign 3840x2160 k=8 {mode}, cold L2",
            "card": card, "kernel_ms": k_ms, "plain_ms": p_ms,
            "kernel_ms_warm_l2": cuda_ms(kernel, 50),
            "kernel_gpix_per_s": HEIGHT * WIDTH / k_ms / 1e6,
        })
    n_4k = HEIGHT * WIDTH
    n_pad = -(-n_4k // (kernels.quant_tile_rows(K) * kernels.LANES)) * (
        kernels.quant_tile_rows(K) * kernels.LANES)
    assign_bound_ms, assign_bound_by = assign_bound(n_4k, n_pad, n_pad // 8, K, K)

    # The accumulator on the trained full-resolution palette's centroids,
    # at the shapes one Lloyd step of the 4K k=8 training gives it.
    cents_full = full.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    accum_ms = {}
    for bf16 in (False, True):
        planes, n_valid = kernels.pack_lab_planes(lab_4k, torch.bfloat16 if bf16 else None)

        def kernel():
            kernels.lloyd_accumulate(planes, cents_full, n_valid)

        def plain():
            kernels.lloyd_accumulate_reference(planes, cents_full, n_valid)

        k_ms, p_ms = cuda_ms(kernel, 20, flush), cuda_ms(plain, 3, flush)
        bound_ms, bound_by = accum_bound(planes.shape[1] * kernels.LANES, n_valid, K, K, 4, bf16)
        accum_ms[bf16] = (k_ms, p_ms, bound_ms, bound_by)
        emit({
            "phase": "timing",
            "what": f"lloyd_accumulate 3840x2160 k=8 {'bf16' if bf16 else 'f32'} planes, cold L2",
            "card": card, "kernel_ms": k_ms, "plain_ms": p_ms,
            "kernel_ms_warm_l2": cuda_ms(kernel, 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_gpix_per_s": n_valid / k_ms / 1e6,
        })
    for k in (64, 256, 512):
        planes, n_valid = kernels.pack_lab_planes(lab_4k)
        cents = random_palette_lab(k, SEED + k, device)

        def kernel():
            kernels.lloyd_accumulate(planes, cents, n_valid)

        bound_ms, bound_by = accum_bound(planes.shape[1] * kernels.LANES, n_valid, k, k, 4)
        emit({
            "phase": "timing", "what": f"lloyd_accumulate 3840x2160 k={k} f32 planes, cold L2",
            "card": card, "kernel_ms": cuda_ms(kernel, 5, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })

    # CIEDE2000 assign, meld under both metrics and the CIEDE2000
    # accumulator, at the shapes of the 4K k=8 slices.
    cents_2000 = proc2000.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    new_times = {}

    def assign_2000():
        kernels.assign_packed(dev, cents_2000, 0.0, metric="cie2000")

    def assign_2000_plain():
        kernels.assign_packed_reference(dev, cents_2000, 0.0, metric="cie2000")

    new_times["assign_cie2000"] = (cuda_ms(assign_2000, 10, flush),
                                   cuda_ms(assign_2000_plain, 3, flush),
                                   *assign_bound(n_4k, n_pad, n_pad // 8, K, K, "cie2000"))
    cents_94 = proc.extract_palette_kmeans(Image((WIDTH, HEIGHT), image), K)
    for metric, meld_cents in (("cie94", cents_94), ("cie2000", cents_2000)):
        def meld():
            kernels.meld_packed(dev, meld_cents, metric=metric)

        def meld_plain():
            kernels.meld_packed_reference(dev, meld_cents, metric=metric)

        new_times[f"meld_{metric}"] = (cuda_ms(meld, 10, flush), cuda_ms(meld_plain, 3, flush),
                                       *meld_bound(n_4k, n_pad, K, K, metric))
    planes, n_valid = kernels.pack_lab_planes(lab_4k)
    n_pix = planes.shape[1] * kernels.LANES
    for k in (K, 64):
        acc_cents = cents_2000 if k == K else random_palette_lab(k, SEED + k, device)

        def acc():
            kernels.lloyd_accumulate(planes, acc_cents, n_valid, metric="cie2000")

        def acc_plain():
            kernels.lloyd_accumulate_reference(planes, acc_cents, n_valid, metric="cie2000")

        new_times[f"lloyd_cie2000_k{k}"] = (
            cuda_ms(acc, 10 if k == K else 3, flush),
            cuda_ms(acc_plain, 3, flush) if k == K else "not measured",
            *accum_bound(n_pix, n_valid, k, k, 4, metric="cie2000"))
    whats = {
        "assign_cie2000": "assign 3840x2160 k=8 replace delta_e=2000, cold L2",
        "meld_cie94": "meld 3840x2160 k=8, cold L2",
        "meld_cie2000": "meld 3840x2160 k=8 delta_e=2000, cold L2",
        "lloyd_cie2000_k8": "lloyd_accumulate 3840x2160 k=8 f32 planes delta_e=2000, cold L2",
        "lloyd_cie2000_k64": "lloyd_accumulate 3840x2160 k=64 f32 planes delta_e=2000, cold L2",
    }
    for key, (k_ms, p_ms, bound_ms, bound_by) in new_times.items():
        emit({"phase": "timing", "what": whats[key], "card": card, "kernel_ms": k_ms,
              "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by})

    fast_times = time_fast(dev, lab_4k, trained, flush, card)
    del flush
    frames_times = time_frames(image, frames, device, card, drive, frames_plain)
    update_cost(image, device, card)

    def entry(name, source, replaces, launches_, err, times, launched_by="ImageProcessor"):
        return {"name": name, "route": "cuda", "source": f"kmeans_tpu_torch/csrc/{source}",
                "replaces": f"kmeans_tpu/ops/kernels.py:{replaces}", "launches": launches_,
                "launched_by": launched_by,
                "max_abs_err": err, "ms": times[0], "plain_ms": times[1],
                "bound_ms": times[2], "bound_by": times[3], "library_ms": None}

    def exp_entry(name, source, replaces, launches_, err, times, launched_by):
        return {**entry(name, source, 0, launches_, err, times, launched_by),
                "source": f"kmeans_tpu_torch/tools/csrc/{source}", "replaces": replaces}

    def fast_launches(mode):
        total = sum(path.get(mode, 0) for path in fast["paths"].values())
        if total < 1:
            raise AssertionError(f"the fast slice never launched {mode}")
        return total

    def frames_launches(mode):
        total = sum(path.get(mode, 0) for path in drive["paths"].values())
        if total < 1:
            raise AssertionError(f"the frames slice never launched {mode}")
        return total

    counts_2000, counts_full_2000 = meld_slice["counts_2000"], meld_slice["counts_full_2000"]
    assign_times = (*timings["replace"], assign_bound_ms, assign_bound_by)
    kernel_lines = [
        entry("assign_packed", "quantize_assign.cu", 669, launches, max_abs_err["cie94"],
              assign_times),
        entry("assign_packed[cie2000]", "quantize_assign.cu", 860,
              counts_2000[0] + counts_full_2000[0], max_abs_err["cie2000"],
              new_times["assign_cie2000"]),
        entry("meld_packed", "quantize_meld.cu", 992, meld_slice["counts_meld"][1],
              meld_err["cie94"], new_times["meld_cie94"]),
        entry("meld_packed[cie2000]", "quantize_meld.cu", 992, counts_2000[1],
              meld_err["cie2000"], new_times["meld_cie2000"]),
        entry("lloyd_accumulate", "lloyd_accumulate.cu", 1270, full_launches,
              accum_err["cie94"], accum_ms[False]),
        entry("lloyd_accumulate[cie2000]", "lloyd_accumulate.cu", 1400,
              counts_full_2000[2], accum_err["cie2000"], new_times["lloyd_cie2000_k8"]),
        # The fast modes, timed at k = 64; launches summed over the fast paths.
        entry("assign_packed[fast cie94, factorized]", "quantize_assign.cu", 885,
              fast_launches("assign_packed cie94 factor"), fast_err["assign", "cie94"],
              fast_times["assign", "cie94", "factor"]),
        entry("assign_packed[fast cie2000, pruned]", "quantize_assign.cu", 892,
              fast_launches("assign_packed cie2000 prune"), fast_err["assign", "cie2000"],
              fast_times["assign", "cie2000", "prune"]),
        entry("meld_packed[fast cie94, factorized]", "quantize_meld.cu", 1033,
              fast_launches("meld_packed cie94 factor"), fast_err["meld", "cie94"],
              fast_times["meld", "cie94", "factor"]),
        entry("meld_packed[fast cie2000, pruned]", "quantize_meld.cu", 1010,
              fast_launches("meld_packed cie2000 prune"), fast_err["meld", "cie2000"],
              fast_times["meld", "cie2000", "prune"]),
        entry("lloyd_accumulate[fast cie94, factorized]", "lloyd_accumulate.cu", 1357,
              fast_launches("lloyd_accumulate cie94 factor"), fast_err["lloyd", "factor"],
              fast_times["lloyd", "cie94", "factor"]),
        entry("lloyd_accumulate[fast cie94, algebraic]", "lloyd_accumulate.cu", 1369,
              fast_launches("lloyd_accumulate cie94 algebraic"), fast_err["lloyd", "algebraic"],
              fast_times["lloyd+inertia", "cie94", "algebraic"],
              launched_by="direct wrapper call, no API route"),
        entry("lloyd_accumulate[fast cie2000, pruned]", "lloyd_accumulate.cu", 1411,
              fast_launches("lloyd_accumulate cie2000 prune"), fast_err["lloyd", "prune"],
              fast_times["lloyd", "cie2000", "prune"]),
        # Colour out (B2), any palette size: 4K k=2048; the chunked instance
        # (past STAGE_CHUNK centroids) at 1080p k=16384.
        entry("quantize_rgba", "quantize_assign.cu", 1104,
              frames_launches("quantize_rgba cie94 exact"),
              colour_err["quantize_rgba", "cie94", False], frames_times["quantize_rgba"]),
        entry("quantize_rgba[chunked]", "quantize_assign.cu", 1104,
              frames_launches("quantize_rgba cie94 exact-chunked"),
              colour_err["quantize_rgba", "cie94", True], frames_times["quantize_rgba[chunked]"]),
        entry("assign_u8", "quantize_assign.cu", 1635,
              frames_launches("assign_u8 cie94 exact"),
              colour_err["assign_u8", "cie94", False], frames_times["assign_u8"],
              launched_by="direct wrapper call, no API route"),
        # The meld kernel past one chunk of staged centroids (the repair).
        entry("meld_packed[chunked]", "quantize_meld.cu", 1878,
              frames_launches("meld_packed cie94 exact-chunked"),
              colour_err["meld_packed", "cie94", True], frames_times["meld_packed[chunked]"]),
        # The frames batch (B7) at 16x1080p: k=8 exact, k=64 fast; colour
        # out on 2 frames at k=2048.
        entry("assign_frames_packed", "quantize_assign.cu", 2092,
              frames_launches("assign_frames_packed cie94 exact"),
              frames_err["packed", "cie94", "exact"], frames_times["assign_frames_packed"]),
        entry("assign_frames_packed[fast cie94, factorized]", "quantize_assign.cu", 2092,
              frames_launches("assign_frames_packed cie94 factor"),
              frames_err["packed", "cie94", "factor"],
              frames_times["assign_frames_packed[fast cie94, factorized]"]),
        entry("assign_frames_packed[fast cie2000, pruned]", "quantize_assign.cu", 2092,
              frames_launches("assign_frames_packed cie2000 prune"),
              frames_err["packed", "cie2000", "prune"],
              frames_times["assign_frames_packed[fast cie2000, pruned]"]),
        entry("meld_frames_packed", "quantize_meld.cu", 2129,
              frames_launches("meld_frames_packed cie94 exact"),
              frames_err["meld", "cie94", "exact"], frames_times["meld_frames_packed"]),
        entry("meld_frames_packed[fast cie94, factorized]", "quantize_meld.cu", 2129,
              frames_launches("meld_frames_packed cie94 factor"),
              frames_err["meld", "cie94", "factor"],
              frames_times["meld_frames_packed[fast cie94, factorized]"]),
        entry("meld_frames_packed[fast cie2000, pruned]", "quantize_meld.cu", 2129,
              frames_launches("meld_frames_packed cie2000 prune"),
              frames_err["meld", "cie2000", "prune"],
              frames_times["meld_frames_packed[fast cie2000, pruned]"]),
        entry("quantize_frames", "quantize_assign.cu", 2057,
              frames_launches("quantize_frames cie94 exact"),
              frames_err["rgba", "cie94", "exact"], frames_times["quantize_frames"]),
        # Port-only: the threshold the reference computes in a fori_loop
        # (no Pallas kernel), timed at k = 2048.
        {**entry("dither_threshold", "dither_threshold.cu", 0, threshold_launches,
                 threshold["err"], threshold["times"]),
         "replaces": "kmeans_tpu/ops/quantize.py:112 (a lax.fori_loop, no Pallas kernel)"},
        # B9 at 4K k=64 (the tool also times k=256), launched by the tool.
        exp_entry("exp_factor_vpu", "exp_mxu.cu", "tools/exp_mxu.py:94",
                  mxu["counts"]["exp_factor_vpu cie94 factor"], mxu[64]["err"][0],
                  mxu[64]["timing"]["vpu"], "kmeans_tpu_torch.tools.exp_mxu"),
        {**exp_entry("exp_factor_mxu", "exp_mxu.cu", "tools/exp_mxu.py:118",
                     mxu["counts"]["exp_factor_mxu cie94 tf32"], mxu[64]["err"][1],
                     mxu[64]["timing"]["mxu"], "kmeans_tpu_torch.tools.exp_mxu"),
         "library_ms": mxu[64]["library"]["off"],
         "library_ms_tf32": mxu[64]["library"]["on"]},
        # B10: the single read of try_form at [128, 128] and the sums of 8
        # over the 4K grid, per table placement, launched by the tool.
        *[{**exp_entry(f"exp_gather[{p}]", "exp_gather.cu", "tools/exp_gather.py:52",
                       gather["counts"][f"exp_gather {p} table"], 0, gather["timing"]["gather", p],
                       "kmeans_tpu_torch.tools.exp_gather"),
           "library_ms": gather["take_ms"]} for p in ("shared", "constant", "global")],
        *[exp_entry(f"exp_lut[{p}]", "exp_gather.cu", "tools/exp_gather.py:152",
                    gather["counts"][f"exp_lut {p} table"], 0, gather["timing"]["lut", p],
                    "kmeans_tpu_torch.tools.exp_gather") for p in ("shared", "constant", "global")],
        exp_entry("exp_pow", "exp_gather.cu", "tools/exp_gather.py:160",
                  gather["counts"]["exp_pow - powf"], gather["pow_err"], gather["timing"]["pow"],
                  "kmeans_tpu_torch.tools.exp_gather"),
        # The tool's helper for powf's ulps against the table: no TPU kernel
        # (the reference makes the table with numpy); err in ulps.
        exp_entry("exp_pow_table", "exp_gather.cu", "tools/exp_gather.py:47 (numpy, no kernel)",
                  gather["counts"]["exp_pow_table - powf"], gather["pow_table_ulps"],
                  gather["timing"]["pow_table"], "kmeans_tpu_torch.tools.exp_gather"),
    ]
    for line in kernel_lines:
        line["design"] = design_of(line["name"])
    emit({"kernels": kernel_lines})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
