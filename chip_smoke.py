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
   them compiles the assign, meld and accumulator sources with `-Xptxas
   -v` and prints a `ptxas` line for each kernel instance (registers,
   stack and spill bytes: a spill in any of their instances fails) and a
   `sass` line for each tiled or screening instance's centroid loop in
   the built library (its instructions, per pixel-centroid pair, by
   opcode), and a `sass` line for each instance of the threshold and
   factor-mxu kernels compiled alone (resources, the compiler's notes of
   a serialized `wgmma`, every opcode's count, the round or step loop:
   factor-mxu must issue `HGMMA`, the threshold's round loop must vote);
   then `srgb_steps`: the meld kernel's sRGB encode by step
   points against `powf` on all 2^32 float32 inputs;
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
   both metrics: equal words, equal counts. `meld_tile_vs_plain` puts the
   same palettes through every meld mode (exact at k = 1..512, chunked
   with 64-centroid chunks, frames with per-frame `k_active`) and
   `fast_screen_vs_plain` through the factorized and pruned tiers of the
   assign, meld and accumulator kernels at k = 17..300;
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
   twin's at k = 1..2048 and 16384, both metrics, random palettes and the
   palette whose every step updates the walk, one, three and 16
   palettes, with each palette's updates; times against the plain loop
   and the latency floor; `reduce(2048)` dither against replace), and
   the experiment tools through their entry points:
   `exp_mxu_vs_plain` (`kmeans_tpu_torch.tools.exp_mxu`: factor-vpu
   against its twin and the fast u8 assign, factor-mxu against its TF32
   twin with each flip a near-tie, `mismatch_frac_vs_exact`, times beside
   `argmin(feats @ G)` with TF32 off and on) and `exp_gather_vs_plain`
   (`kmeans_tpu_torch.tools.exp_gather`: each table placement returns the
   table's bits, the lut sums equal their twin, the pow sums their twin's
   bits or counted ulps, the pow kernel's own curve and each of its
   divides on all 256 inputs against `powf` and the true divides, times
   beside `torch.take`);
   Then the bucketing slice (`ImageProcessor(device="cuda",
   bucketing=True)`): bucketed `find`, `find_batch` and `find_many` equal
   to unbucketed `find` at 3840x2160, 1920x1080, 1080x1350 and 37x53 with
   16 and 5 colours; bucketed `reduce` at k = 8 and 5 (replace, dither,
   meld; 4K and 1080p), each output equal to the plain version's for its
   trained palette, with its agreement with the unbucketed port and its
   launches by kernel mode; the full-resolution bucketed reduce of 1080p
   on the weighted accumulator (launches, counts against the twin's and
   the unpadded image's); `reduce_many` of 16 mixed images (three
   buckets) in turns with 16 `reduce` calls (images/s, launches, host
   syncs, outputs against the solo calls) and `palette_many`; `warmup`
   timed in fresh processes (`python3 chip_smoke.py --warmup-probe
   warmup|none`: the library built anew inside it, then warm; the first
   `reduce` after it against a fresh process's first); a 300x420
   bucketed reduce on the card against the CPU.
   Then the host palette algorithms and the command line:
   `palette_algos` (octree, median cut and Wu through `palette` and
   `reduce` on the 4K image and a 1920x1080 one, unbucketed and bucketed,
   k = 8 and 16: the shrink's bytes on the card against the CPU's, each
   palette against the CPU's, each replace, dither and meld output against
   the plain twin's on the same palette, 0 differing pixels, with each
   call's launches; the host milliseconds of each algorithm and of the
   shrink) and `cli_slice` (the 4K image written as a PNG by the port's
   codec, then `kmeans_tpu_torch.cli.main` on the card for `reduce` with
   each algorithm, dither and meld, `palette -s 40`, `find` with 3
   colours, `--train-max-size none` and `--delta-e 2000`: each output file
   decodes to the equivalent `ImageProcessor` call's pixels, with its
   launches and its seconds split into decode, encode and the rest; then
   `validate_kernels()` must return True).
   Then streaming in row bands (`streaming_slice`): on a 12288x12288
   image, `find_streamed` with 16 colours in three modes in bands of
   4096 and 1001 rows, each equal to the whole-image bucketed `find`;
   `reduce_streamed` in three modes (dither at both splits, equal),
   `palette_streamed`, and `reduce_streamed` at `train_max_size=2048`
   (the weighted accumulator), each call with its launches (assign or
   meld one a band, the threshold one a dither call, the accumulator one
   an iteration) and its seconds by phase; the peak device memory of
   `reduce_streamed` at 12288x12288 and 12288x6144 beside the bucketed
   `reduce`; on the 4K image in bands of 1001 rows each band's words
   against the plain twins' with its `row_offset`, `find_streamed` with
   2048 colours (RGBA) against the bucketed `find`; an image within the
   cap against the bucketed `reduce`; 1920x1080 in bands of 256 on the
   card against the CPU; `reduce_pipelined` over 8 frames (1080p and
   720p), unbucketed and bucketed, each output equal to its solo
   `reduce`, timed against 8 sequential `reduce` calls in turns with
   each one's device idle share.
   Then the native host runtime and the HTTP service: `runtime_probe`
   (the host's `cc`, whether `png.h`, `jpeglib.h` and `zlib.h` exist: the
   runtime's PNG and JPEG unit builds only with the first two);
   `native_vs_twins` (the 4K image's native strip and its output pass's
   unpack in three modes against the numpy twins, and `reduce_streamed` of
   2002x12288 in bands of 1001 with the twins in the native paths' place:
   0 bytes apart); `codec_slice` (the 4K PNG through the native codec
   against `png_py`, or through `png_py` where the unit is not built, JPEG
   or its refusal; a 24-frame 640x360 GIF through the CLI's `reduce-gif`
   in both palette modes and `find-gif`, 0 pixels apart from the API's
   frames, delays kept; the CLI's 4K `reduce -c 8` by phase; the fuzz tool
   at 300 mutants); `serving_slice` (`kmeans_tpu_torch.serve` in this
   process over a warmed bucketed processor: the `docs/serving.md`
   traffic, 8 clients x 3 requests of 320x240 at k=8 on `/reduce`,
   `/find`, `/palette` and mixed at windows 0 and 25 ms, 1080p requests,
   a JPEG body, the GIF endpoints, health, stats, the dimension-bomb 400
   and the 503 backpressure at `max_pending=2`; every 200 equal to the
   processor's direct call, each run's launches counted).
   Then multi-device sharding (`sharding_slice`) on meshes of 1, 2 and 4
   shards of the one card (`make_mesh(["cuda:0"] * d)`, and 2x2 data x
   pixel for the frames): `find_sharded` with 16 colours in three modes,
   on a 2161-row image and with 2048 colours (colour out a shard), each
   equal to `find` bit for bit with one launch a shard; the sharded seeds
   equal to `plusplus_init`'s on the shrunk and the 4K stores;
   `reduce_sharded` on the shrunk training (three modes), the
   full-resolution one (the accumulator launched shards x iterations
   times), `delta_e="2000"`, the k=600 row-chunked route on 640x600 and
   bucketed on 1080x1350, each against `reduce` (a one-shard mesh bit for
   bit, more shards at least 0.999 of the pixels), `palette_sharded`
   within 2 u8 of `palette`, one mesh twice equal; 16 frames of 1920x1080
   through `reduce_images_sharded` (2x2), `palette_images_sharded` (and
   its octree fallback) and `find_batch_sharded` in three modes (bit for
   bit); each shard's words against the twins with its `row_offset`; a
   2-shard 320x240 `reduce_sharded` on the card against the CPU; 4K k=8
   `reduce` against `reduce_sharded` on 1, 2 and 4 shards in turns (the
   shards share one card: the protocol's cost, not scaling).
   Then pipeline mode (`pipeline_slice`, `ImageProcessor(pipeline=True)`)
   on the 4K image at k=8: the host strip against the device shrink (bytes
   apart, at most one u8 step); the palette against `pipeline=False`
   (channels apart) and the card's against the CPU's (equal), with the
   bytes each uploads (the strip's against the image's); the banded
   `reduce` in replace and dither (5 bands of 512 rows, the last of 112)
   against the monolithic pass on the same centroids (0 pixels apart),
   with one assign launch a band and one threshold launch for dither, and
   each band's words against the plain twin with its `row_offset`; the
   CLI's `--pipeline reduce` on the 4K PNG against the API and `serve.main
   --pipeline` answering `/palette` of it as the direct call; then
   `reduce` (replace, dither) and `palette` at `pipeline=True` against
   `pipeline=False`, the median of 5 warm runs in turns, their phases from
   3 more runs, and one profiled call of each (device idle share), and the
   timeline of one pipelined call (host strip, band strips, training,
   passes, unpacks).
   Then `seed_ties` (farthest-point seeding at exact ties): the 2x2
   two-colour image at k=8 and six flat regions at k=16, both metrics,
   palette and reduce in three modes on the card against the CPU (0
   apart; the 2x2 palette 6 red rows and 2 blue, as the JAX package
   seeds), and the CUDA kernel launches of one seeding of the 4K k=8
   training shrink with the compiled-form seed side and on stored Lab
   alone; `examples_slice` (each of `kmeans_tpu_torch/examples/` once on
   the card on a PNG written from a seeded 256x192 image: 14 GIF frames of
   at most k colours each from `gif` and `batched`, every `serving` output
   equal to the processor's direct call, the `sharded` example's output
   on a one-shard mesh equal to `reduce_sharded`'s bit for bit and its
   4-shard run with the 2x2 frames mesh); and `soak_slice`
   (`kmeans_tpu_torch/tools/soak.py` with a fixed seed and a 60 s budget:
   its trials and launches by section, no failure);
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
`launched_by` says whether they came through `ImageProcessor`, the
command line, `validate_kernels` (the u8-index assign's one route), an
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
from pathlib import Path

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
# where the exact forms have 9; the algebraic distance reads only rsh2 and
# q of them: 13. The pruned tier needs at least
# the score and one compare against the list for every centroid (13), and
# for each of its min(m, k_active) survivors one walk into the list (2 m
# selects) and one exact CIEDE2000 distance (105). The reference's
# insertion network runs its 2 m selects for every centroid; the kernel
# skips the walk when the score is not below the list's last, so the bound
# counts only the walks that the result needs.
SCREEN_OPS = 13
ALGEBRAIC_OPS = 14
PIXEL_OPS = {"exact": 9, "factor": 20, "algebraic": 13, "prune": 20}


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


START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries `t_s`, the seconds since
    the script started (the script must end within the card call's limit)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
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
    """CIE94 and the fast tiers: equal words. Exact CIEDE2000: within 1 u8
    step on at most 1e-4 of the pixels."""
    if line["metric"] == "cie94" or line.get("tier", "exact") != "exact":
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


def cuda_ms(fn, reps: int, flush=None, headroom_cycles: int = 0) -> float:
    """Mean milliseconds per call of `fn` on the current stream, after one
    warm-up call, by CUDA events. With `flush` (a tensor larger than the
    L2 cache), it is overwritten before each call, outside the timed span,
    so each call starts with a cold cache. With `headroom_cycles`, the card
    then spins that long, also outside the span, while the host enqueues
    the call: a kernel of a few microseconds is timed, not its wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if headroom_cycles:
            torch.cuda._sleep(headroom_cycles)
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
    output is held against the plain version's for the same palette, and
    the algebraic accumulator against its twin at its tile's edges.
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
    # The algebraic register tile against its twin at its edges: n_valid
    # off the tile (100,003 pixels), a weight plane, bf16 and float32
    # planes, k_active < kp, kp = 512. Equal counts (the assignments'
    # tallies) and the sums, the assigned distances' among them, within
    # 1e-5 of scale.
    edge_lab = random_lab(ACCUM_PIXELS, SEED + 1800, device)
    for k, k_active, bf16 in ((512, 300, True), (64, 40, False)):
        line = accum_case(edge_lab, k, device, k_active=k_active, weighted=True, inertia=True,
                          bf16=bf16, fast=True)
        emit({**line, "phase": "fast_slice_algebraic_vs_plain"})
        if not (line["tier"] == "algebraic" and line["counts_equal"] and line["deterministic"]
                and line["max_err_over_scale"] <= 1e-5):
            raise AssertionError(f"the algebraic tile disagrees with its twin: {line}")

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
THRESHOLD_EVERY_STEP_KS = (8, 2048, 16384)
THRESHOLD_FRAMES = 16
GRID_FRAMES = 65_537  # past the 65,535 frames one grid's y extent holds
MXU_RAGGED = (61, 97, 100)
# factor-vpu's register tile (`kVpuTilePixels` in tools/csrc/exp_mxu.cu)
# and the sizes that leave pixels past its last whole tile: 61x97 =
# 5,917 pixels, 1x2053 = 8 x 256 + 5, 7x3 below one tile. The row slice
# [1:] of the odd-width 61x97 image starts 4-byte, not 16-byte, aligned.
VPU_TILE_PIXELS = 8
VPU_RAGGED = ((61, 97), (1, 2053), (7, 3))
# The sums of 8 table reads (`kLutCopies`, `kLutVec` in
# tools/csrc/exp_gather.cu): copies of the staged table, elements a thread
# takes an iteration.
LUT_COPIES = 32
LUT_VEC = 4
# The pow sum's elements a thread an iteration (`kPowVec` in
# tools/csrc/exp_gather.cu).
POW_VEC = 4
# B10's kernels and their library calls are timed with the card spinning
# ~0.5 ms after each flush, while the host enqueues the wrapper's launch.
GATHER_HEADROOM_CYCLES = 1_000_000
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
    `THRESHOLD_KS` and at k = 16384, both metrics, on a random palette and
    on the palette whose every step updates the walk (`every_step`), one
    palette and B = 3 palettes with per-frame `k_active` (B = 3 up to
    k = 1024), and B = 16 random palettes at k = 2048: equal bits, and
    each palette's updates (`tools/threshold_walk.py::count_updates`). The
    plain loop's time is that of its checked run (one call; not kept at
    k = 16384 under CIEDE2000, where the one run only checks the bits);
    the kernel's the mean of 20 launches, each after the L2 flush (which
    keeps the card busy while the host enqueues the next launch, so the
    time is the kernel's and not the wrapper's). Then the latency floor of
    the timed k=2048 palettes: the k = 1 launch plus one round of the
    every-step palette per update. Then `reduce(2048)` dither against
    replace end to end, in turns. Returns the k=2048 CIE94 times for the
    kernels line."""
    import torch

    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.ops.quantize import (
        dither_threshold,
        dither_threshold_reference,
        dither_thresholds,
        dither_thresholds_reference,
    )
    from kmeans_tpu_torch.tools.threshold_walk import count_updates, every_step_palette

    failures, times, updates = [], {}, {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for metric in ("cie94", "cie2000"):
        for k in THRESHOLD_KS + (HUGE_K,):
            for kind in ("random", "every_step"):
                if kind == "every_step" and k not in THRESHOLD_EVERY_STEP_KS:
                    continue
                cents = (random_palette_lab(k, SEED + 50 + k, device) if kind == "random"
                         else every_step_palette(k, device))
                got = dither_threshold(cents, metric=metric)
                twin = []
                plain_ms = _events_ms(lambda: twin.append(
                    dither_threshold_reference(cents, metric=metric)))
                equal = bool(got.view(torch.int32) == twin[0].view(torch.int32))
                updates[metric, kind, k] = count_updates(cents, metric)
                line = {"phase": "dither_threshold_vs_plain", "k": k, "metric": metric,
                        "palette": kind, "frames": 1, "equal_bits": equal,
                        "threshold": float(got), "updates": updates[metric, kind, k]}
                if k >= 1024 or kind == "every_step" or k == 1:
                    kernel_ms = cuda_ms(lambda: dither_threshold(cents, metric=metric), 20, flush)
                    if k == HUGE_K and metric == "cie2000":
                        plain_ms = "not measured"
                    times[metric, kind, k] = (kernel_ms, plain_ms)
                    line.update({"card": card, "kernel_ms": kernel_ms, "plain_ms": plain_ms})
                if k <= 1024 and kind == "random":
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
                    failures.append(f"dither_threshold k={k} {metric} {kind}")
        pals = torch.stack([random_palette_lab(BIG_K, SEED + 80 + f, device)
                            for f in range(THRESHOLD_FRAMES)])
        g = dither_thresholds(pals, None, metric)
        w = dither_thresholds_reference(pals, None, metric)
        equal = bool(torch.equal(g.view(torch.int32), w.view(torch.int32)))
        line = {"phase": "dither_threshold_vs_plain", "k": BIG_K, "metric": metric,
                "palette": "random", "frames": THRESHOLD_FRAMES, "equal_bits": equal,
                "updates": [count_updates(pal, metric) for pal in pals], "card": card,
                "kernel_ms": cuda_ms(lambda: dither_thresholds(pals, None, metric), 20, flush)}
        emit(line)
        if not equal:
            failures.append(f"dither_thresholds {THRESHOLD_FRAMES} x k={BIG_K} {metric}")
    del flush
    if failures:
        raise AssertionError("; ".join(failures))
    floors = {}
    for metric in ("cie94", "cie2000"):
        step = ((times[metric, "every_step", HUGE_K][0] - times[metric, "every_step", 8][0])
                / (HUGE_K - 8))
        launch = times[metric, "random", 1][0]
        for k in (BIG_K, HUGE_K):
            n = updates[metric, "random", k]
            floors[metric, k] = launch + n * step
            emit({"phase": "timing", "what": f"dither_threshold k={k} {metric} random, floor",
                  "card": card, "kernel_ms": times[metric, "random", k][0], "updates": n,
                  "every_step_round_ms": step, "launch_ms": launch,
                  "latency_floor_ms": floors[metric, k]})
    proc = ImageProcessor(device="cuda")
    for line in timed_reduces({
        "reduce 3840x2160 k=2048 replace, median of 2 warm": (proc, ReduceMode.REPLACE),
        "reduce 3840x2160 k=2048 dither, median of 2 warm": (proc, ReduceMode.DITHER),
    }, image, card, k=2048, rounds=3):
        emit(line)
    kernel_ms, plain_ms = times["cie94", "random", BIG_K]
    # Each palette entry is read once and one float written; the walk is
    # two distances and a square root per centroid.
    bound = _bound(BIG_K * 12 + 4, 2 * (BIG_K - 2) * (METRIC_OPS["cie94"] + 1) + 2)
    return {"times": (kernel_ms, plain_ms, *bound), "err": 0,
            "latency_floor_ms": floors["cie94", BIG_K],
            "updates": updates["cie94", "random", BIG_K]}


def exp_mxu_vs_plain(device, card) -> dict:
    """B9 through its entry point, the tool `kmeans_tpu_torch.tools.exp_mxu`:
    its evaluation pass (one launch of each kernel at k = 64 and 256 on the
    seeded 3840x2160 image) with the counts set to 0 just before it; then,
    on the same data and on a ragged 61x97 k=100 case, factor-vpu against
    its twin (0 differing indices) and `assign_u8(fast=True)`, factor-mxu
    against its TF32 twin (each flip a near-tie); the kernels' and the
    twins' times beside `argmin(feats @ G)` with TF32 off and on; factor-vpu
    against its twin at k = 64 and 256 on sizes past its last whole tile
    (`VPU_RAGGED`) and on row slices that start off a 16-byte boundary,
    and its launcher's refusal of such words; then the tool's own timing
    lines. Returns the k=64 figures for the kernels line."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.gamma_lut import gamma_lut
    from kmeans_tpu_torch.tools import _exp, exp_mxu

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
    # factor-vpu alone at sizes that leave a tail past its last whole
    # tile, and on a view that starts off a 16-byte boundary (the wrapper
    # takes it through an aligned copy; the launcher refuses it).
    rng = np.random.default_rng(SEED + 71)
    for h, w in VPU_RAGGED:
        img_r = torch.from_numpy(exp_mxu.random_image(h, w, rng)).to(device)
        for kp in ks:
            cents = torch.from_numpy(exp_mxu.random_centroids(kp, rng)).to(device)
            views = [("whole", img_r)] + ([("rows [1:]", img_r[1:])] if h > 1 else [])
            for what, view in views:
                vpu = exp_mxu.factor_vpu(view, cents)
                line = {"phase": "exp_mxu_vs_plain", "kernel": "factor_vpu", "h": h, "w": w,
                        "k": kp, "view": what, "pixels": view.shape[0] * view.shape[1],
                        "tail_pixels": view.shape[0] * view.shape[1] % (256 * VPU_TILE_PIXELS),
                        "address_mod_16": view.data_ptr() % 16,
                        "vpu_differing_vs_twin": int(
                            (vpu != exp_mxu.factor_vpu_reference(view, cents)).sum())}
                emit(line)
                if line["vpu_differing_vs_twin"]:
                    failures.append(f"exp_mxu factor_vpu: {line}")
    h, w = VPU_RAGGED[0]
    words = torch.from_numpy(exp_mxu.random_image(h, w, rng)).to(device)[1:].reshape(-1, 4)
    words = words.view(torch.int32)
    cents = torch.from_numpy(exp_mxu.random_centroids(ks[0], rng)).to(device)
    out_r = torch.empty(words.shape[0], dtype=torch.uint8, device=device)
    lib = _exp.load_exp_library()
    refused = lib.exp_factor_vpu(words.data_ptr(), words.shape[0],
                                 kernels.factor_g_table(cents).data_ptr(), cents.shape[0],
                                 gamma_lut(device).data_ptr(), out_r.data_ptr(),
                                 _exp.stream_of(out_r))
    emit({"phase": "exp_mxu_vs_plain", "kernel": "factor_vpu",
          "launcher_on_misaligned_words": lib.exp_error_string(refused).decode()})
    if refused != exp_mxu.CUDA_ERROR_MISALIGNED_ADDRESS:
        failures.append(f"factor_vpu's launcher took a misaligned image: {refused}")
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
    sum and the curve probe once, the constant placement filled once) with
    the counts set to 0 just before it; every placement must return the
    table's bits; the lut sums against their twin (equal bits), the pow sum
    against its twin (bits, or ulps counted: at most 8), `powf`'s table
    against numpy's; the curve probe (`pow_curve_probe`): the kernel's own
    curve on all 256 inputs against `powf`'s term (at most 8 ulps) and
    each of its divides against the true divide on every input it takes
    (equal bits); the constant placement across table changes
    (`constant_follows_table`) and the device operations of one call with
    its table resident (one kernel);
    the kernels' and twins' times beside `torch.take` for the gather, the
    fill alone and an empty kernel (the launch floor); then the tool's own
    timing lines."""
    import torch

    from kmeans_tpu_torch.tools import _exp
    from kmeans_tpu_torch.tools import exp_gather as eg

    reset_launch_counts()
    tool_lines = eg.measure(device, reps=0)
    torch.cuda.synchronize()
    counts = mode_counts()
    want = {f"exp_gather {p} table": 1 for p in eg.PLACEMENTS}
    want.update({f"exp_lut {p} table": 1 for p in eg.PLACEMENTS})
    # The constant placement's one fill serves its gather and its sum.
    want.update({"exp_pow - curve": 1, "exp_pow_probe - curve": 1, "exp_pow_table - powf": 1,
                 "exp_lut_fill constant copy": 1})
    correct = {line["form"]: line["correct"] for line in tool_lines if "form" in line}
    pow_table = next(line for line in tool_lines if "pow_table_vs_numpy" in line)
    probe = next(line for line in tool_lines if "pow_curve_probe" in line)["pow_curve_probe"]
    divides_exact = all(probe[d]["entries_differing"] == 0
                        for d in ("divide_255", "divide_1055", "divide_1292"))
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
            "pow_table_vs_twin_max_ulps": int(table_ulps.max()), **pow_table,
            "pow_curve_probe": probe}
    emit(line)
    if counts != want or not all(correct.values()) or not all(lut_equal.values()) \
            or int(ulps.max()) > 8 or int(table_ulps.max()) > 8 or not divides_exact \
            or probe["curve_vs_powf"]["max_ulps"] > 8:
        raise AssertionError(f"exp_gather: {line} (launches wanted {want})")
    follows = constant_follows_table(table, idx, grid)
    # One resident call's device operations: one kernel, no copy.
    resident_ops = _exp.device_ops(lambda: eg.gather(table, idx, "constant"))
    emit({"phase": "exp_gather_vs_plain", "constant_resident_device_ops": resident_ops})
    if len(resident_ops) > 1 or any("lut_kernel" not in op for op in resident_ops):
        raise AssertionError(f"a resident constant-placement call ran {resident_ops}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    n_small, n_grid = idx.numel(), grid.numel()
    timing = {}
    spin = GATHER_HEADROOM_CYCLES
    for p in eg.PLACEMENTS:
        timing["gather", p] = (cuda_ms(lambda p=p: eg.gather(table, idx, p), 50, flush, spin),
                               cuda_ms(lambda: eg.gather_reference(table, idx), 20, flush),
                               *_bound(8 * n_small + 1024, n_small))
        timing["lut", p] = (cuda_ms(lambda p=p: eg.lut_sum(table, grid, p), 20, flush, spin),
                            cuda_ms(lambda: eg.lut_sum_reference(table, grid), 5, flush),
                            *_bound(8 * n_grid + 1024, 8 * n_grid))
    timing["pow"] = (cuda_ms(lambda: eg.pow_sum(grid), 20, flush, spin),
                     cuda_ms(lambda: eg.pow_sum_reference(grid), 5, flush),
                     *_bound(8 * n_grid, 8 * 8 * n_grid))
    # The probe: five rows of 256 written, the curve and the first form's
    # term evaluated once an input (8 operations each, as the sums count).
    timing["pow_probe"] = (cuda_ms(lambda: eg.pow_probe(device), 50, flush, spin),
                           cuda_ms(lambda: eg.pow_probe_reference(device), 50, flush),
                           *_bound(4 * 256 * len(eg.PROBE_ROWS), 2 * 8 * 256))
    timing["pow_table"] = (cuda_ms(lambda: eg.pow_table(device), 50, flush, spin),
                           cuda_ms(lambda: eg.pow_table_reference(device), 50, flush),
                           *_bound(4 * 256, 2 * 256))
    idx_long = idx.long()  # torch.take indexes by int64
    take_ms = cuda_ms(lambda: torch.take(table, idx_long), 50, flush, spin)
    # The constant placement's fill alone, the launch floor, and the sums'
    # bytes moved by a plain copy (what the card's memory allows).
    fill_ms = cuda_ms(lambda: eg.fill_constant(table), 50, flush, spin)
    empty_ms = cuda_ms(lambda: eg.empty(device), 50, flush, spin)
    copied = torch.empty(grid.shape, dtype=torch.float32, device=device)
    copy_ms = cuda_ms(lambda: copied.copy_(grid.view(torch.float32)), 20, flush, spin)
    del flush, copied
    emit({"phase": "timing", "what": "exp_gather kernels (cold L2, 0.5 ms headroom, mean)",
          "card": card, "take_ms": take_ms, "fill_ms": fill_ms, "empty_kernel_ms": empty_ms,
          "copy_4k_grid_ms": copy_ms,
          **{" ".join(key) if isinstance(key, tuple) else key: {
              "kernel_ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3]}
             for key, t in timing.items()}})
    for tline in eg.measure(device, reps=20):
        emit({"phase": "timing", "what": "exp_gather tool", "card": card, **tline})
    return {"counts": counts, "timing": timing, "take_ms": take_ms, "fill_ms": fill_ms,
            "empty_ms": empty_ms, "copy_ms": copy_ms, "resident_ops": resident_ops,
            "follows": follows, "pow_err": line["pow_max_abs_err"],
            "pow_table_ulps": line["pow_table_vs_twin_max_ulps"],
            "probe_ulps": probe["curve_vs_powf"]["max_ulps"]}


def constant_follows_table(table, idx, grid) -> dict:
    """The constant placement across table changes: the tool's table, a
    second table, the first again, then the first written in place twice;
    each call's gather and sum of 8 against their twins bit for bit, and
    the fills each change made (one; none for a second call)."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.tools import exp_gather as eg

    fills = ("exp_lut_fill", "constant", "copy")
    first = table.clone()
    other = torch.from_numpy(np.random.default_rng(SEED + 19).random(256, dtype=np.float32)).to(
        table.device)
    steps = [("first table", first, None), ("second table", other, None),
             ("first table again", first, None),
             ("first written in place (x0.5)", first, lambda t: t.mul_(0.5)),
             ("first, entries 100-255 written in place", first,
              lambda t: t[100:].copy_(other[:156]))]
    cases, failures = [], []
    for what, tab, write in steps:
        if write is not None:
            write(tab)
        for call in (1, 2):
            before = kernels.LAUNCHES_BY_MODE[fills]
            same = {
                "gather": bool(torch.equal(eg.gather(tab, idx, "constant").view(torch.int32),
                                           eg.gather_reference(tab, idx).view(torch.int32))),
                "lut_sum": bool(torch.equal(eg.lut_sum(tab, grid, "constant").view(torch.int32),
                                            eg.lut_sum_reference(tab, grid).view(torch.int32)))}
            made = kernels.LAUNCHES_BY_MODE[fills] - before
            cases.append({"table": what, "call": call, "equal_bits": same, "fills": made})
            if not all(same.values()) or made != (1 if call == 1 else 0):
                failures.append(cases[-1])
    emit({"phase": "exp_gather_vs_plain", "constant_follows_table": cases})
    if failures:
        raise AssertionError(f"constant placement across table changes: {failures}")
    return {"cases": len(cases), "all_equal_bits": True}


def update_cost(image, device, card) -> None:
    """C.1's cost: the shrunk training (256x144 of the 4K image) at k = 8
    and k = 2048 with the float64 one-hot product against the float32 one
    it replaced (full float32, TF32 off), in turns (f64, f32, f32, f64,
    three times over)."""
    import torch

    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.resize import resize_uint8

    def update_f32(pixels, assign, k, weight=None):  # unweighted here
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


# The pixel-centroid pairs an iteration of a kernel's centroid loop
# visits, to turn the loop's length into instructions a pair: the pixels
# of the register tiles of the exact and factorized tiers (`tile_pixels`
# in csrc/quantize_assign.cu and csrc/quantize_meld.cu, `kTilePixels` in
# csrc/lloyd_accumulate.cu for all three; CIEDE2000 one pixel at a time), and
# the two centroids an iteration of the pruned screen takes past its first
# m (one pixel; its loop found by its warp vote, `SCREEN_LOOPS`; the count
# holds the insertions a warp skips unless a lane needs one).
LOOP_PAIRS = {"assign_kernel<0,0,0,": 2, "assign_kernel<1,0,0,": 1, "assign_kernel<0,1,0,": 2,
              "assign_kernel<1,3,": 2, "meld_kernel<0,0,0,0": 1, "meld_kernel<0,0,0,1": 4,
              "meld_kernel<1,0,0,": 1, "meld_kernel<0,1,0,": 4, "meld_kernel<1,3,": 2,
              "lloyd_tile_kernel<0,0": 8, "lloyd_tile_kernel<0,1": 8, "lloyd_tile_kernel<0,2": 8,
              "lloyd_tile_kernel<1,0": 1, "lloyd_tile_kernel<1,3,": 2}
# The pruned accumulator's blocks an SM must hold (`kPruneMinBlocks` in
# csrc/lloyd_accumulate.cu, its `__launch_bounds__`).
LLOYD_PRUNE_MIN_BLOCKS = 4
SCREEN_LOOPS = {"assign_kernel<1,3,": "VOTE", "meld_kernel<1,3,": "VOTE",
                "lloyd_tile_kernel<1,3,": "VOTE"}
ADVERSARIAL = ("duplicates", "grey", "pixel_is_centroid", "inf", "tiny", "k_active")


# The design each kernel line runs. The assign kernel (every tier and
# output mode) and the meld kernel scan a register tile of pixels against
# 16-byte centroid loads, CIE94 dividing through hoisted reciprocals
# (CIEDE2000 one pixel at a time), the pruned tier screening by packed
# keys; the accumulator's tiers all sum by warp groups, its exact CIE94,
# factorized and algebraic tiers once a register tile; factor-vpu scores a
# register tile against padded feature rows.
def design_of(name: str) -> str:
    if name.startswith("meld"):
        if "chunked" in name:
            return "register tile across chunks, hoisted reciprocals, sRGB by table"
        if "pruned" in name:
            return "keyed screen, 16-byte loads, d(closest, second) and sRGB by table"
        if "cie2000" in name:
            return "one pixel a thread, 16-byte loads, d(closest, second) and sRGB by table"
        return "register tile, hoisted reciprocals, d(closest, second) and sRGB by table"
    if name.startswith(("assign", "quantize")):
        if "pruned" in name:
            return "keyed screen (network, then gated insertion), one pixel a thread"
        if "factorized" in name:
            return "register tile, padded feature rows"
        if "cie2000" in name:
            return "one pixel a thread, 16-byte centroid loads"
        return "register tile, hoisted reciprocals"
    if name == "lloyd_accumulate":
        return "register tile, hoisted reciprocals, warp-group sums"
    if name == "lloyd_accumulate[fast cie94, factorized]":
        return (f"register tile of {LOOP_PAIRS['lloyd_tile_kernel<0,1']} pixels, padded "
                "feature rows, one warp-group sum a tile")
    if name == "lloyd_accumulate[fast cie94, algebraic]":
        return (f"register tile of {LOOP_PAIRS['lloyd_tile_kernel<0,2']} pixels, 16-byte "
                "centroid loads, one warp-group sum a tile")
    if name == "lloyd_accumulate[fast cie2000, pruned]":
        return (f"one pixel at a time, keyed screen, warp-group sums, {LLOYD_PRUNE_MIN_BLOCKS} "
                "blocks an SM (64 registers): the grid resident at once")
    if name.startswith("lloyd_accumulate"):
        return "one pixel at a time, warp-group sums"
    if name == "exp_factor_vpu":
        return (f"experiment tool: register tile of {VPU_TILE_PIXELS} pixels, padded "
                "feature rows, one 32-bit store a run")
    if name in ("exp_lut[shared]", "exp_lut[constant]"):
        return (f"experiment tool: the table staged once a block as {LUT_COPIES} interleaved "
                f"copies (a bank a lane), {LUT_VEC} elements a thread an iteration")
    if name == "exp_gather[constant]":
        return ("experiment tool: filled only when the table changed, staged into shared "
                "memory by one constant address a warp a read")
    if name == "exp_pow":
        return (f"experiment tool: the curve computed for its 256 inputs (two-float reciprocal "
                f"divides, powf's path without its checks), {POW_VEC} elements a thread an "
                "iteration")
    if name.startswith("exp_"):
        return "experiment tool"
    if name == "dither_threshold":
        return "one block a palette, first-trigger scan by warp votes"
    return "one thread a word"


def compiler_report(lib_path, ptxas) -> None:
    """`ptxas` lines (registers, stack and spill bytes of every instance of
    the assign, meld and accumulator kernels, from `-Xptxas -v`) and
    `sass` lines (the tiled and screening instances' centroid loops in the
    built library: its instructions, per pixel-centroid pair, and by
    opcode). Fails on a spill in any of their instances."""
    from kmeans_tpu_torch.tools import sass

    spills = []
    for source, rows in ptxas.items():
        for row in rows:
            emit({"phase": "ptxas", "source": source, **row})
            if row["kernel"].startswith(("assign_kernel<", "meld_kernel<", "lloyd_tile_kernel<")):
                if row["spill_store_bytes"] or row["spill_load_bytes"]:
                    spills.append(row)
    for name, loop in sass.centroid_loops(lib_path, require=SCREEN_LOOPS).items():
        pairs = next((v for k, v in LOOP_PAIRS.items() if name.startswith(k)), None)
        if loop is None or pairs is None:
            continue
        emit({"phase": "sass", "kernel": name, "loop_start": loop["start"],
              "instructions": loop["instructions"], "pairs_per_iteration": pairs,
              "instructions_per_pair": loop["instructions"] / pairs, "opcodes": loop["opcodes"]})
    if spills:
        raise AssertionError(f"spills: {spills}")


# The loop each kernel below is read by: the threshold's round loop of one
# warp by its vote and the five square roots of its two distances (three
# chromas, two distances), factor-mxu's step loop by its warpgroup MMA,
# factor-vpu's centroid loop by its feature-row load and the six products
# of each pixel of its tile (the tail's one-pixel loop has six).
LOOP_OPCODES = {"dither_threshold_kernel": "VOTE+MUFU.RSQ*5", "factor_mxu_kernel": "HGMMA",
                "factor_vpu_kernel": f"LDS.128+FMUL*{6 * VPU_TILE_PIXELS}",
                f"lut_kernel<0,8,{LUT_VEC}>": f"LDS*{8 * LUT_VEC}",
                f"lut_kernel<1,8,{LUT_VEC}>": f"LDS*{8 * LUT_VEC}",
                f"pow_kernel<{POW_VEC}>": f"MUFU.RCP*{8 * POW_VEC}"}
# What no instance of the pow sum may hold: a shared-memory read (a table),
# a divide's slow path (its check and the call), a conversion between int
# and float (`I2F`, `I2FP`, `F2I`) or `FRND`.
POW_FORBIDDEN = ("LDS", "FCHK", "CALL", "I2F", "F2I", "FRND")


def pow_kernel_check(row) -> dict:
    """The pow sum's instance `row` of `kernel_report`: the opcodes it must
    not hold, no spill, and its element loop's global loads (the 16-byte
    index load alone), reciprocals (one an evaluation: 8 an element) and
    instructions an evaluation. Raises on a breach."""
    found = sorted(op for op in row["kernel_opcodes"] if op.startswith(POW_FORBIDDEN))
    out = {"forbidden_opcodes": list(found)}
    if row.get("spill_store_bytes") or row.get("spill_load_bytes"):
        found.append("spills")
    loop = row["loop"]
    if row["loop_opcode"]:
        if loop is None:
            raise AssertionError(f"{row['kernel']}: no element loop found")
        evaluations = 8 * POW_VEC
        ops = loop["opcodes"]
        out.update({"evaluations_per_iteration": evaluations,
                    "instructions_per_evaluation": loop["instructions"] / evaluations,
                    "global_loads_per_iteration": {op: n for op, n in ops.items()
                                                   if op.startswith("LDG")}})
        if out["global_loads_per_iteration"] not in ({"LDG.E.128.CONSTANT": 1},
                                                     {"LDG.E.128": 1}):
            found.append(f"loop loads {out['global_loads_per_iteration']}")
        if ops.get("MUFU.RCP") != evaluations:
            found.append(f"{ops.get('MUFU.RCP')} MUFU.RCP a loop, not {evaluations}")
    if found:
        raise AssertionError(f"{row['kernel']}: {found}")
    return out


def scan_report(rows) -> None:
    """`sass` lines of the threshold and factor-mxu kernels (compiled
    alone): `ptxas` resources and warnings, every opcode's count, and the
    round loop; factor-vpu's centroid loop and its instructions a pair.
    Fails unless factor-mxu issues `HGMMA` (Hopper's `wgmma.mma_async`)
    and the threshold's round loop votes, or if factor-vpu spills, or if
    the pow sum fails `pow_kernel_check`."""
    found = set()
    for row in rows:
        if row["kernel"].startswith("factor_vpu_kernel") and row["loop"]:
            row = {**row, "pairs_per_iteration": VPU_TILE_PIXELS,
                   "instructions_per_pair": row["loop"]["instructions"] / VPU_TILE_PIXELS}
        if row["kernel"].startswith("lut_kernel") and row["loop_opcode"]:
            reads = (sum(n for op, n in row["loop"]["opcodes"].items() if op.startswith("LDS"))
                     / LUT_VEC if row["loop"] else None)
            row = {**row, "elements_per_iteration": LUT_VEC, "table_reads_per_element": reads}
            if reads != 8:
                raise AssertionError(f"{row['kernel']}: {reads} table reads an element, not 8")
        if row["kernel"].startswith("pow_kernel<"):
            row = {**row, **pow_kernel_check(row)}
        emit({"phase": "sass", **row})
        if row["kernel"].startswith("factor_mxu_kernel") and any(
                op.startswith("HGMMA") for op in row["kernel_opcodes"]):
            found.add("HGMMA")
        if row["kernel"].startswith("dither_threshold_kernel") and row["loop"]:
            found.add("VOTE")
        if row["kernel"].startswith("factor_vpu_kernel") and (
                row.get("spill_store_bytes") or row.get("spill_load_bytes")):
            raise AssertionError(f"factor_vpu_kernel spills: {row}")
    if found != {"HGMMA", "VOTE"}:
        raise AssertionError(f"sass: found {sorted(found)} of HGMMA (factor-mxu) and VOTE "
                             f"(the threshold's round loop)")


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


def meld_tile_checks(device) -> None:
    """`meld_tile_vs_plain`: the meld kernel's tiles on the adversarial
    palettes: exact CIE94 and CIEDE2000 at k = 1..512 (the `d(closest,
    second)` table up to 16 colours), the chunked instance with
    64-centroid chunks at k = 300, and the frames mode with per-frame
    `k_active` (exact k = 8, factorized and pruned k = 64). CIE94 and the
    fast tiers: equal words; exact CIEDE2000: within 1 u8 step on at most
    1e-4 of the pixels, the bar the kernel has always had against this
    twin (`meld_ok`)."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.utils.packing import unpack_rgb24_tile_words

    def line_of(got, want, h, w, k, metric, **what):
        rows = kernels.quant_tile_rows(k)
        a = unpack_rgb24_tile_words(got.cpu().numpy(), h, w, rows).astype(np.int64)
        b = unpack_rgb24_tile_words(want.cpu().numpy(), h, w, rows).astype(np.int64)
        step = np.abs(a - b).max(-1)
        return {"phase": "meld_tile_vs_plain", "metric": metric, "k": k, **what,
                "mismatched_words": int((got != want).sum().item()),
                "differing_pixels": int((step > 0).sum()), "max_channel_step": int(step.max()),
                "pixels": h * w}

    failures = []
    lines = []
    for metric in ("cie94", "cie2000"):
        for k in (1, 8, 16, 17, 64, 512):
            for case in ADVERSARIAL:
                rgb, cents, k_active = adversarial_case(case, k, 5000 + k, device)
                lines.append(line_of(kernels.meld_packed(rgb, cents, k_active, metric),
                                     kernels.meld_packed_reference(rgb, cents, k_active, metric),
                                     37, 53, k, metric, case=case))
        chunk = kernels.STAGE_CHUNK
        kernels.STAGE_CHUNK = 64
        try:
            for case in ("duplicates", "inf", "tiny", "k_active"):
                rgb, cents, k_active = adversarial_case(case, 300, 5300, device, 29, 41)
                lines.append(line_of(kernels.meld_packed(rgb, cents, k_active, metric),
                                     kernels.meld_packed_reference(rgb, cents, k_active, metric),
                                     29, 41, 300, metric, case=case, chunk=64))
        finally:
            kernels.STAGE_CHUNK = chunk
        for k, fast in ((8, False), (64, True)):
            parts = [adversarial_case(case, k, 5400 + k, device, 30, 41)
                     for case in ("duplicates", "inf", "tiny")]
            frames = torch.stack([q[0] for q in parts])
            cents = torch.stack([q[1] for q in parts]).contiguous()
            k_actives = [k, max(1, k // 2), max(1, k - 3)]
            got = kernels.meld_frames_packed(frames, cents, k_actives, metric, fast)
            want = kernels.meld_frames_packed_reference(frames, cents, k_actives, metric, fast)
            for f in range(3):
                lines.append(line_of(got[f], want[f], 30, 41, k, metric, frames=3, frame=f,
                                     tier=kernels.assign_tier(fast, metric, k)))
    for line in lines:
        emit(line)
        if not meld_ok(line):
            failures.append(f"meld_tile_vs_plain: {line}")
    if failures:
        raise AssertionError("; ".join(failures))


def fast_screen_checks(device) -> None:
    """`fast_screen_vs_plain`: the factorized CIE94 tile and the pruned
    CIEDE2000 keyed screen on the adversarial palettes at k = 17, 129,
    300: packed dither, RGBA and (k <= 256) u8 assign words and meld words
    equal to the twins'; the fast accumulators' counts equal and sums
    within 1e-5 of scale."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    failures = []
    for metric in ("cie94", "cie2000"):
        for k in (17, 129, 300):
            for case in ADVERSARIAL:
                rgb, cents, k_active = adversarial_case(case, k, 5600 + k, device)
                args = (rgb, cents, 1.5, k_active, "dither", 1, metric, True)
                pairs = [(kernels.assign_packed, kernels.assign_packed_reference),
                         (kernels.quantize_rgba, kernels.quantize_rgba_reference)]
                if k <= 256:
                    pairs.append((kernels.assign_u8, kernels.assign_u8_reference))
                words = sum(int((call(*args) != twin(*args)).sum().item()) for call, twin in pairs)
                melds = int((kernels.meld_packed(rgb, cents, k_active, metric, True)
                             != kernels.meld_packed_reference(rgb, cents, k_active, metric,
                                                              True)).sum().item())
                line = {"phase": "fast_screen_vs_plain", "metric": metric, "k": k,
                        "case": case, "tier": kernels.assign_tier(True, metric, k),
                        "mismatched_words": words, "mismatched_meld_words": melds}
                if k != 300:
                    planes, n = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
                    acc = (planes, cents, n, k_active, None, metric, True)
                    got = kernels.lloyd_accumulate(*acc, fast=True)
                    want = kernels.lloyd_accumulate_reference(*acc, fast=True)
                    rows = torch.isfinite(cents).all(-1) | (want[:, 3] == 0)
                    bound = 1e-5 * (want.double().abs() + 128.0 * want[:, 3:4].double())
                    line["counts_equal"] = bool(torch.equal(got[:, 3], want[:, 3]))
                    line["sums_within_bar"] = bool(
                        ((got.double() - want.double()).abs() <= bound)[rows].all())
                emit(line)
                if words or melds or not line.get("counts_equal", True) \
                        or not line.get("sums_within_bar", True):
                    failures.append(f"fast_screen_vs_plain: {line}")
    if failures:
        raise AssertionError("; ".join(failures))


def srgb_step_check(device) -> None:
    """`srgb_steps`: the meld kernel's sRGB encode by step points against
    `powf` on all 2^32 float32 inputs (`tools/srgb_steps.py`): the
    encode never decreases and maps NaN and negatives to 0, the committed
    points give its byte on every input, and the points found anew equal
    the committed ones."""
    from kmeans_tpu_torch.tools import srgb_steps

    out = srgb_steps.check_on_card(device)
    same = out["steps"][1:] == srgb_steps.committed_steps()[1:]
    emit({"phase": "srgb_steps", "inputs": 1 << 32, "broken": out["broken"],
          "differ": out["differ"], "steps_equal_committed": same, "seconds": out["seconds"]})
    if out["broken"] or out["differ"] or not same:
        raise AssertionError("the sRGB step points do not give powf's bytes")


# --- The bucketing slice --------------------------------------------------------

# The sizes of the bucketing slice: 4K, 1080p, a 4:5 portrait and a
# small odd size (37x53 pads off the Bayer period); (height, width).
BUCKET_SIZES = ((2160, 3840), (1080, 1920), (1350, 1080), (37, 53))
BUCKET_FIND_KS = (16, 5)  # 5 pads to the k bucket 8
# A smoke mix of three buckets (1280x2048, 768x1280, 1536x1280).
MANY_BATCH = ((1080, 1920, 8), (720, 1280, 4), (1350, 1080, 4))
WARMUP_SIZES = ((1920, 1080), (1280, 720), (1080, 1350))  # (width, height)


def _bucket_frame(h, w, seed):
    """An image of `h`x`w`: the synthetic gradient-plus-noise frame
    with its channels rolled by the seed, so images of one size differ."""
    img = synthetic_image(h, w, seed=seed)
    img[..., :3] = np.roll(img[..., :3], seed % 3, axis=-1)
    return img


def _pixels_equal(a, b) -> float:
    return float((a == b).all(-1).mean())


def _bucketed_plain(bproc, image, k, mode):
    """The plain version of a bucketed reduce's output: the bucketed
    training again (deterministic on the card), then the plain twin of the
    output pass on the padded image with `k_active = k`, unpacked and
    cropped as the entry point does."""
    from kmeans_tpu_torch.api import _lab_palette_to_u8, _unpack_gather, _unpack_meld
    from kmeans_tpu_torch.image import Image
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.utils.bucketing import bucket_k, bucket_shape

    h, w = image.shape[:2]
    bh, bw = bucket_shape(h, w)
    kp = bucket_k(k)
    dev = bproc._upload_padded([Image((w, h), image)], bh, bw)[0]
    cents = bproc._train_bucketed(dev, kp, w, h, k)
    if mode == "meld":
        words = kernels.meld_packed_reference(dev, cents, k)
        return _unpack_meld(words.cpu().numpy(), bh, bw, kp)[:h, :w]
    thr = dither_threshold(cents, k) if mode == "dither" else 0.0
    words = kernels.assign_packed_reference(dev, cents, thr, k, mode=mode)
    return _unpack_gather(words.cpu().numpy(), bh, bw, kp,
                          _lab_palette_to_u8(cents)[0].cpu().numpy())[:h, :w]


def _count_syncs(call):
    """`(result, host synchronisations)` of `call()`: torch's sync debug
    mode warns once for each operation that waits for the card."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = call()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def bucketing_find(device) -> dict:
    """Bucketed `find`, `find_batch` and `find_many` against unbucketed
    `find` on the card: every pixel equal, replace and dither, 16 and 5
    colours (k bucket 16 and 8), at the slice's sizes. Returns the
    launches by kernel mode of the bucketed calls (each counted from 0
    just before it; the unbucketed calls it is held against are not
    counted)."""
    from kmeans_tpu_torch import ImageProcessor, ReduceMode

    bproc, uproc = ImageProcessor(device="cuda", bucketing=True), ImageProcessor(device="cuda")
    images = {(h, w): _bucket_frame(h, w, 50 + i) for i, (h, w) in enumerate(BUCKET_SIZES)}
    twins = {size: _bucket_frame(*size, 60 + i) for i, size in enumerate(BUCKET_SIZES[1:])}
    counts: dict = {}

    def counted(call):
        reset_launch_counts()
        out = call()
        launches = mode_counts()
        for key, n in launches.items():
            counts[key] = counts.get(key, 0) + n
        return out, launches

    def differing(got, frames, colors, mode):
        return sum(int((g.pixels != uproc.find(f, colors, mode).pixels).any(-1).sum())
                   for g, f in zip(got, frames))

    failures = []
    for k in BUCKET_FIND_KS:
        colors = np.random.default_rng(SEED + k).integers(0, 256, (k, 3), dtype=np.uint8)
        for mode in (ReduceMode.REPLACE, ReduceMode.DITHER):
            for (h, w), img in images.items():
                got, _ = counted(lambda: bproc.find(img, colors, mode))
                differ = differing([got], [img], colors, mode)
                emit({"phase": "bucketing_find", "call": "find", "size": [h, w], "k": k,
                      "mode": mode.value, "differing_pixels": differ})
                if differ:
                    failures.append(f"find {h}x{w} k={k} {mode.value}: {differ}")
            # find_batch: two frames of each size; find_many: all sizes, the
            # 4K image alone in its bucket, the others in pairs.
            for size, twin in twins.items():
                pair = [images[size], twin]
                got, _ = counted(lambda: bproc.find_batch(pair, colors, mode))
                differ = differing(got, pair, colors, mode)
                emit({"phase": "bucketing_find", "call": "find_batch", "size": list(size),
                      "k": k, "mode": mode.value, "differing_pixels": differ})
                if differ:
                    failures.append(f"find_batch {size} k={k} {mode.value}: {differ}")
            many = list(images.values()) + list(twins.values())
            got, launches = counted(lambda: bproc.find_many(many, colors, mode))
            differ = differing(got, many, colors, mode)
            emit({"phase": "bucketing_find", "call": "find_many", "images": len(many), "k": k,
                  "mode": mode.value, "differing_pixels": differ, "launches": launches})
            if differ:
                failures.append(f"find_many k={k} {mode.value}: {differ}")
    if failures:
        raise AssertionError("bucketed find differs from find: " + "; ".join(failures))
    return counts


def bucketing_reduce(device) -> dict:
    """Bucketed `reduce` at k = 8 and 5 (k bucket 8, three masked rows) in
    replace, dither and meld on the 4K image and 1080p: each output equals
    the plain version's for its trained palette; the palette's agreement
    with the unbucketed port (u8) and the share of equal pixels are
    printed. Then the full-resolution bucketed reduce(8) of 1080p (the
    1280x2048 canvas, 21% of it weight 0) through the weighted
    accumulator: its launches, and its counts on the same weighted canvas
    against the twin's and against the unpadded image's. Returns the
    launches by kernel mode."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.models.kmeans import _weight_plane
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.utils.bucketing import bucket_shape

    bproc, uproc = ImageProcessor(device="cuda", bucketing=True), ImageProcessor(device="cuda")
    counts: dict = {}
    for h, w in BUCKET_SIZES[:2]:
        img = _bucket_frame(h, w, 70)
        for k in (8, 5):
            step = int(np.abs(bproc.palette(k, img).astype(int)
                              - uproc.palette(k, img).astype(int)).max())
            for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
                reset_launch_counts()
                out = bproc.reduce(k, img, reduce_mode=mode).pixels
                launches = mode_counts()
                for key, n in launches.items():
                    counts[key] = counts.get(key, 0) + n
                plain = _bucketed_plain(bproc, img, k, mode.value)
                differ = int((plain != out).any(-1).sum())
                line = {"phase": "bucketing_reduce", "size": [h, w], "k": k,
                        "mode": mode.value, "colors": len(unique_rgba(out)),
                        "differing_from_plain": differ, "launches": launches,
                        "palette_max_u8_step_vs_unbucketed": step,
                        "pixels_equal_to_unbucketed": _pixels_equal(
                            out, uproc.reduce(k, img, reduce_mode=mode).pixels)}
                emit(line)
                if differ or out.shape != (h, w, 4) or (
                        mode is not ReduceMode.MELD and line["colors"] > k):
                    raise AssertionError(f"bucketed reduce: {line}")
    # Full resolution: the weighted accumulator on the padded canvas.
    h, w = BUCKET_SIZES[1]
    img = _bucket_frame(h, w, 71)
    full = ImageProcessor(device="cuda", bucketing=True, train_max_size=None)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = full.reduce(K, img).pixels
    seconds = time.perf_counter() - t0
    launches = mode_counts()
    for key, n in launches.items():
        counts[key] = counts.get(key, 0) + n
    bh, bw = bucket_shape(h, w)
    dev = full._upload_padded([Image((w, h), img)], bh, bw)[0]
    cents = full._train_bucketed(dev, K, w, h, K)
    work, weight, _ = full._canvas_lab(dev[None], (bh, bw), [h], [w], [h], [w])
    planes, n_valid = kernels.pack_lab_planes(work[0])
    wplane = _weight_plane(weight[0])
    got = kernels.lloyd_accumulate(planes, cents, n_valid, weight_planes=wplane)
    want = kernels.lloyd_accumulate_reference(planes, cents, n_valid, weight_planes=wplane)
    alone, n_alone = kernels.pack_lab_planes(srgb8_to_lab(
        torch.from_numpy(np.ascontiguousarray(img[..., :3])).to(device).reshape(-1, 3)))
    unpadded = kernels.lloyd_accumulate(alone, cents, n_alone)
    plain = _bucketed_plain(full, img, K, "replace")
    scale = want.double().abs() + 128.0 * want[:, 3:4].double()
    line = {
        "phase": "bucketing_full_res", "size": [h, w], "canvas": [bh, bw],
        "weight_zero_share": 1 - h * w / (bh * bw), "iterations": full.last_iterations,
        "seconds": seconds, "launches": launches,
        "counts_equal_twin": bool(torch.equal(got[:, 3], want[:, 3])),
        "counts_equal_unpadded": bool(torch.equal(got[:, 3], unpadded[:, 3])),
        "max_err_over_scale": float(((got.double() - want.double()).abs() / scale).max()),
        "differing_from_plain": int((plain != out).any(-1).sum()),
    }
    emit(line)
    if (launches.get("lloyd_accumulate cie94 exact", 0) != full.last_iterations
            or not line["counts_equal_twin"] or not line["counts_equal_unpadded"]
            or line["max_err_over_scale"] > 1e-5 or line["differing_from_plain"]):
        raise AssertionError(f"full-resolution bucketed reduce: {line}")
    return counts


def bucketing_many(card: str) -> dict:
    """`reduce_many` of a smoke mix of 16 images (8 of 1920x1080, 4 of
    1280x720, 4 of 1080x1350 at k = 8, replace: three buckets) in turns
    with 16 sequential bucketed `reduce` calls, median of 3 each: images/s,
    kernel launches and host synchronisations each way; every output and
    every `palette_many` palette against the solo call's; the phases of
    each way and a profiled call of each (the device's idle share).
    Returns the coalesced run's launches by kernel mode."""
    from kmeans_tpu_torch import ImageProcessor
    from kmeans_tpu_torch.utils.profiling import collect_phases

    bproc = ImageProcessor(device="cuda", bucketing=True)
    batch = [_bucket_frame(h, w, 80 + 10 * j + i)
             for j, (h, w, n) in enumerate(MANY_BATCH) for i in range(n)]
    reset_launch_counts()
    coalesced, many_syncs = _count_syncs(lambda: bproc.reduce_many(batch, K))
    many_launches = mode_counts()
    reset_launch_counts()
    solo, solo_syncs = _count_syncs(lambda: [bproc.reduce(K, im) for im in batch])
    solo_launches = mode_counts()
    differ = sum(int((a.pixels != b.pixels).any(-1).sum()) for a, b in zip(coalesced, solo))
    reset_launch_counts()
    pals = bproc.palette_many(batch, K)
    pal_launches = mode_counts()
    pal_equal = all((p == bproc.palette(K, im)).all() for p, im in zip(pals, batch))
    runs = {"reduce_many": [], "reduce": []}
    for _ in range(3):
        for what in runs:
            phases: dict = {}
            t0 = time.perf_counter()
            with collect_phases(phases):
                if what == "reduce_many":
                    bproc.reduce_many(batch, K)
                else:
                    for im in batch:
                        bproc.reduce(K, im)
            runs[what].append((time.perf_counter() - t0, phases))
    med = {what: statistics.median(r[0] for r in rs) for what, rs in runs.items()}
    phase_ms = {what: {name: statistics.median(r[1].get(name, 0.0) for r in rs) * 1e3
                       for name in ("host_prep", "upload", "device", "lloyd_sync", "readback",
                                    "unpack")}
                for what, rs in runs.items()}
    line = {
        "phase": "timing", "what": "reduce_many of 16 mixed images (8 1920x1080, 4 1280x720, "
        "4 1080x1350) k=8 replace against 16 bucketed reduce calls, median of 3 in turns",
        "card": card, "reduce_many_ms": med["reduce_many"] * 1e3,
        "reduce_ms": med["reduce"] * 1e3,
        "reduce_many_ms_each": [r[0] * 1e3 for r in runs["reduce_many"]],
        "reduce_ms_each": [r[0] * 1e3 for r in runs["reduce"]],
        "reduce_many_phases_ms": phase_ms["reduce_many"], "reduce_phases_ms": phase_ms["reduce"],
        "reduce_many_images_per_s": len(batch) / med["reduce_many"],
        "reduce_images_per_s": len(batch) / med["reduce"],
        "launches_reduce_many": many_launches, "launches_reduce": solo_launches,
        "syncs_reduce_many": many_syncs, "syncs_reduce": solo_syncs,
        "differing_pixels_vs_solo": differ, "pixels": sum(im.shape[0] * im.shape[1]
                                                          for im in batch),
        "palette_many_launches": pal_launches, "palette_many_equal_solo": bool(pal_equal),
    }
    emit(line)
    if differ or not pal_equal:
        raise AssertionError(f"reduce_many / palette_many against solo calls: {line}")
    if many_launches.get("assign_frames_packed cie94 exact", 0) != 3:
        raise AssertionError(f"reduce_many took {many_launches}, want 3 frames launches")
    emit(profile_call(lambda: bproc.reduce_many(batch, K), card,
                      "reduce_many of the 16 mixed images"))
    emit(profile_call(lambda: [bproc.reduce(K, im) for im in batch], card,
                      "16 bucketed reduce calls of the mixed images"))
    return many_launches


def warmup_probe(kind: str) -> int:
    """Run in a fresh process by `bucketing_warmup`: `kind="warmup"` builds
    the library into an empty build directory inside `warmup` (its cold
    seconds), calls `warmup` again (its warm seconds), then times the first
    1080p `reduce`; `kind="none"` times a fresh process's first `reduce`
    with the library already built. Prints one JSON line."""
    import shutil

    import torch

    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.ops import _build

    torch.zeros(1, device="cuda")  # the CUDA context, outside every timed span
    proc = ImageProcessor(device="cuda", bucketing=True)
    image = _bucket_frame(1080, 1920, 90)
    out = {"probe": kind}
    probe_dir = _build.BUILD_DIR.parent / "warmup_probe"
    if kind == "warmup":
        shutil.rmtree(probe_dir, ignore_errors=True)
        _build.BUILD_DIR = probe_dir
        for key in ("cold_s", "warm_s"):
            t0 = time.perf_counter()
            out["count"] = proc.warmup(WARMUP_SIZES, [K], modes=(ReduceMode.REPLACE,
                                                                 ReduceMode.DITHER))
            torch.cuda.synchronize()
            out[key] = time.perf_counter() - t0
    for key in ("first_reduce_s", "second_reduce_s"):
        t0 = time.perf_counter()
        proc.reduce(K, image)
        out[key] = time.perf_counter() - t0
    shutil.rmtree(probe_dir, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


def bucketing_warmup(card: str) -> None:
    """`warmup` over the smoke mix's three sizes at k = 8 (replace,
    dither), each probe in a fresh process: with the library not yet built
    and again once built, its count, and the first `reduce` after it
    against the first `reduce` of a fresh process without it."""
    probes = {}
    for kind in ("warmup", "none"):
        res = subprocess.run([sys.executable, __file__, "--warmup-probe", kind],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"warmup probe {kind} failed: {res.stderr[-2000:]}")
        probes[kind] = json.loads(res.stdout.strip().splitlines()[-1])
    line = {"phase": "timing", "what": "warmup of 3 sizes at k=8 (replace, dither), "
            "fresh processes", "card": card, **{f"{k}_{key}": v for k, p in probes.items()
                                                for key, v in p.items() if key != "probe"}}
    emit(line)
    if line["warmup_count"] != 9:
        raise AssertionError(f"warmup issued {line['warmup_count']} requests, want 9")


def bucketing_card_vs_cpu() -> None:
    """A 300x420 bucketed reduce on the card against the same on the CPU."""
    from kmeans_tpu_torch import ImageProcessor, ReduceMode

    small = synthetic_image(300, 420, seed=SEED + 2)
    card_p = ImageProcessor(device="cuda", bucketing=True)
    cpu_p = ImageProcessor(device="cpu", bucketing=True)
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
        step = np.abs(card_p.reduce(K, small, reduce_mode=mode).pixels.astype(np.int64)
                      - cpu_p.reduce(K, small, reduce_mode=mode).pixels).max(-1)
        same_palette = bool((card_p.palette(K, small) == cpu_p.palette(K, small)).all())
        differ = int((step > 0).sum())
        emit({"phase": "card_vs_cpu", "mode": f"bucketed {mode.value}", "pixels": 300 * 420,
              "differing_pixels": differ, "max_channel_step": int(step.max()),
              "same_palette": same_palette})
        bar = 1e-3 if mode is ReduceMode.MELD else 1e-4
        if not same_palette or differ > bar * 300 * 420 or step.max() > (
                1 if mode is ReduceMode.MELD else 255):
            raise AssertionError(f"bucketed card vs cpu {mode.value}: {differ} pixels differ")


def bucketing_slice(device, card: str) -> dict:
    """The bucketing slice, `ImageProcessor(device="cuda", bucketing=True)`,
    each path driven with the launch counts set to 0 just before it and
    read just after. Returns the launches by kernel mode of its paths."""
    t0 = time.perf_counter()
    counts: dict = {}
    for path in (lambda: bucketing_find(device), lambda: bucketing_reduce(device),
                 lambda: bucketing_many(card)):
        for key, n in path().items():
            counts[key] = counts.get(key, 0) + n
    bucketing_warmup(card)
    bucketing_card_vs_cpu()
    emit({"phase": "bucketing_slice", "seconds": time.perf_counter() - t0,
          "launches": counts})
    return counts


# --- The host palette algorithms and the command line -----------------------

ALGO_KS = (8, 16)
# The CLI slice's calls on the 4K PNG: (name, argv after the input and
# output, the equivalent `ImageProcessor` keyword arguments, the call).
CLI_CALLS = (
    ("reduce kmeans", ["reduce", "-c", "8"], {}, ("reduce", 8, "kmeans", "replace")),
    ("reduce octree", ["reduce", "-c", "8", "-a", "octree"], {},
     ("reduce", 8, "octree", "replace")),
    ("reduce mediancut", ["reduce", "-c", "8", "-a", "mediancut"], {},
     ("reduce", 8, "mediancut", "replace")),
    ("reduce wu", ["reduce", "-c", "8", "-a", "wu"], {}, ("reduce", 8, "wu", "replace")),
    ("reduce dither", ["reduce", "-c", "8", "-m", "dither"], {},
     ("reduce", 8, "kmeans", "dither")),
    ("reduce meld", ["reduce", "-c", "8", "-m", "meld"], {}, ("reduce", 8, "kmeans", "meld")),
    ("palette -s 40", ["palette", "-c", "8", "-s", "40"], {}, ("palette", 8, "kmeans", 40)),
    ("find 3 colours", ["find", "-p", "#1E1E28,#C8503C,#3CB4DC"], {},
     ("find", "#1E1E28,#C8503C,#3CB4DC", None, "replace")),
    ("--train-max-size none reduce", ["reduce", "-c", "8"], {"train_max_size": None},
     ("reduce", 8, "kmeans", "replace")),
    ("--delta-e 2000 reduce", ["reduce", "-c", "8"], {"delta_e": "2000"},
     ("reduce", 8, "kmeans", "replace")),
)


def _host_palette_plain(dev, palette_u8, mode):
    """The plain version of a host-palette `reduce`'s output pass: the
    palette to Lab on the host (as the entry point does), then the twin of
    the assign or meld kernel (and of the threshold) on the unpadded image,
    unpacked as the entry point unpacks."""
    import torch

    from kmeans_tpu_torch.api import _colors_to_lab, _lab_palette_to_u8, _unpack_gather
    from kmeans_tpu_torch.api import _unpack_meld
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold_reference

    h, w = dev.shape[0], dev.shape[1]
    lab = torch.from_numpy(_colors_to_lab(palette_u8)).to(dev.device)
    k = lab.shape[0]
    if mode == "meld":
        return _unpack_meld(kernels.meld_packed_reference(dev, lab).cpu().numpy(), h, w, k)
    thr = dither_threshold_reference(lab) if mode == "dither" else 0.0
    words = kernels.assign_packed_reference(dev, lab, thr, mode=mode)
    return _unpack_gather(words.cpu().numpy(), h, w, k, _lab_palette_to_u8(lab)[0].cpu().numpy())


def palette_algos(image, card: str) -> dict:
    """`palette_algos`: octree, median cut and Wu through the entry points on
    the 4K image and a 1920x1080 one, unbucketed and bucketed, at k = 8 and
    16. For each image and mode: the shrink's bytes on the card against the
    CPU's (`_shrunk_pixels`: the eager shrink, or under bucketing the
    canvas shrink), with its milliseconds. For each algorithm and k: the
    palette on the card against the CPU's, with the host milliseconds of the
    algorithm; then `reduce` in replace, dither and meld, each output
    against the plain twin's on the same palette (0 differing pixels:
    CIE94 meld equals its twin too) and each call's launches (replace: one
    assign; dither: one assign and one threshold; meld: one meld; palette:
    none). Each call is counted from 0 just before it. Returns the
    launches by kernel mode summed over the phase."""
    import torch

    from kmeans_tpu_torch import Algorithm, Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import OCTREE_MAX_SIZE
    from kmeans_tpu_torch.utils.profiling import collect_phases

    t_phase = time.perf_counter()
    images = {"3840x2160": image, "1920x1080": synthetic_image(1080, 1920, seed=SEED + 20)}
    want_launches = {"replace": {"assign_packed cie94 exact": 1},
                     "dither": {"assign_packed cie94 exact": 1,
                                "dither_threshold cie94 exact": 1},
                     "meld": {"meld_packed cie94 exact": 1}}
    counts: dict = {}
    failures = []
    for name, img in images.items():
        h, w = img.shape[:2]
        dev = torch.from_numpy(np.ascontiguousarray(img[..., :3])).to("cuda")
        for bucketing in (False, True):
            card_p = ImageProcessor(device="cuda", bucketing=bucketing)
            cpu_p = ImageProcessor(device="cpu", bucketing=bucketing)
            shrink_ms = []
            for _ in range(3):
                phases: dict = {}
                with collect_phases(phases):
                    shrunk = card_p._shrunk_pixels(Image((w, h), img), OCTREE_MAX_SIZE)
                shrink_ms.append(phases.get("shrink", 0.0) * 1e3)
            want = cpu_p._shrunk_pixels(Image((w, h), img), OCTREE_MAX_SIZE)
            differ = int((shrunk != want).sum())
            emit({"phase": "palette_algos", "what": "shrink", "image": name,
                  "bucketing": bucketing, "card": card, "shape": list(shrunk.shape),
                  "differing_bytes": differ, "bytes": int(want.size),
                  "shrink_ms_each": shrink_ms})
            if differ or shrunk.shape != want.shape:
                failures.append(f"shrink {name} bucketing={bucketing}: {differ} bytes differ")
            for algo in (Algorithm.OCTREE, Algorithm.MEDIANCUT, Algorithm.WU):
                for k in ALGO_KS:
                    phases = {}
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    with collect_phases(phases):
                        pal = card_p.palette(k, img, algo)
                    palette_ms = (time.perf_counter() - t0) * 1e3
                    palette_launches = mode_counts()
                    cpu_pal = cpu_p.palette(k, img, algo)
                    same = pal.shape == cpu_pal.shape and bool((pal == cpu_pal).all())
                    line = {"phase": "palette_algos", "what": "palette", "image": name,
                            "bucketing": bucketing, "algo": algo.value, "k": k,
                            "colors": int(pal.shape[0]), "same_palette_as_cpu": same,
                            "card": card, "e2e_ms": palette_ms,
                            "host_palette_ms": phases.get("host_palette", 0.0) * 1e3,
                            "shrink_ms": phases.get("shrink", 0.0) * 1e3,
                            "upload_ms": phases.get("upload", 0.0) * 1e3,
                            "launches": palette_launches, "reduce": {}}
                    if not same or palette_launches:
                        failures.append(f"palette {name} {algo.value} k={k} "
                                        f"bucketing={bucketing}: same {same}, "
                                        f"launches {palette_launches}")
                    for mode in ("replace", "dither", "meld"):
                        reset_launch_counts()
                        out = card_p.reduce(k, img, algo, ReduceMode(mode)).pixels
                        torch.cuda.synchronize()
                        launches = mode_counts()
                        for key, n in launches.items():
                            counts[key] = counts.get(key, 0) + n
                        plain = _host_palette_plain(dev, pal, mode)
                        differ = int((out != plain).any(-1).sum())
                        line["reduce"][mode] = {"differing_pixels": differ,
                                                "colors": len(unique_rgba(out)),
                                                "launches": launches}
                        if differ or launches != want_launches[mode]:
                            failures.append(f"reduce {name} {algo.value} k={k} {mode} "
                                            f"bucketing={bucketing}: {differ} pixels differ, "
                                            f"launches {launches}")
                    emit(line)
    emit({"phase": "palette_algos", "seconds": time.perf_counter() - t_phase,
          "launches": counts})
    if failures:
        raise AssertionError("palette_algos: " + "; ".join(failures))
    return counts


def cli_slice(image, card: str, workdir) -> dict:
    """`cli_slice`: the 4K image written as a PNG by the port's codec, then
    `kmeans_tpu_torch.cli.main` in this process on the card for each of
    `CLI_CALLS`. Each output file decodes to the pixels of the equivalent
    `ImageProcessor(device="cuda")` call on the decoded image (the palette
    call: its swatch), with at most k colours; each call's launches (counted
    from 0 just before it) and seconds, split into decode, encode and the
    rest. Then `validate_kernels()` must return True. Returns the launches
    by kernel mode of the CLI calls and, under `"validate_kernels"`, of the
    validation."""
    import contextlib
    import io

    from kmeans_tpu_torch import Algorithm, ImageProcessor, ReduceMode, cli
    from kmeans_tpu_torch.ops.validate import validate_kernels
    from kmeans_tpu_torch.utils import png_py
    from kmeans_tpu_torch.utils.imageio import load_image
    from kmeans_tpu_torch.utils.profiling import collect_phases

    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    src = workdir / "smoke4k.png"
    t0 = time.perf_counter()
    src.write_bytes(png_py.encode_png(WIDTH, HEIGHT, np.ascontiguousarray(image).tobytes()))
    emit({"phase": "cli_slice", "what": "write the 4K PNG", "seconds": time.perf_counter() - t0,
          "bytes": src.stat().st_size})
    decoded = load_image(src)
    if not (decoded.pixels == image).all():
        raise AssertionError("the port's PNG codec did not round-trip the 4K image")
    counts: dict = {}
    failures = []
    for name, argv, kwargs, (call, k, algo, mode) in CLI_CALLS:
        out = workdir / f"out-{name.replace(' ', '_')}.png"
        full = ([] if not kwargs else
                ["--train-max-size", "none"] if "train_max_size" in kwargs else
                ["--delta-e", "2000"])
        full += argv[:1] + ["-i", str(src), "-o", str(out)] + argv[1:]
        phases: dict = {}
        reset_launch_counts()
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with collect_phases(phases), contextlib.redirect_stdout(stdout):
            rc = cli.main(full)
        seconds = time.perf_counter() - t0
        launches = mode_counts()
        for key, n in launches.items():
            counts[key] = counts.get(key, 0) + n
        got = load_image(out).pixels
        proc = ImageProcessor(device="cuda", **kwargs)
        if call == "reduce":
            want = proc.reduce(k, decoded, Algorithm(algo), ReduceMode(mode)).pixels
        elif call == "find":
            want = proc.find(decoded, cli.parse_colors(k), ReduceMode(mode)).pixels
        else:
            want = cli.render_swatch(proc.palette(k, decoded, Algorithm(algo)), mode)
        n_colors = len(unique_rgba(got))
        limit = 3 if call == "find" else 8
        # The shrunk k-means training of `palette` launches no kernel.
        ok = (rc == 0 and got.shape == want.shape and bool((got == want).all())
              and (mode == "meld" or n_colors <= limit) and (call == "palette" or launches))
        decode_s, encode_s = phases.get("decode", 0.0), phases.get("encode", 0.0)
        emit({"phase": "cli_slice", "call": name, "argv": full[:full.index("-i")] + argv[1:],
              "card": card, "seconds": seconds, "decode_s": decode_s, "encode_s": encode_s,
              "rest_s": seconds - decode_s - encode_s,
              "phases_ms": {n: v * 1e3 for n, v in phases.items() if n != "_syncs"},
              "equal_to_api": bool(got.shape == want.shape and (got == want).all()),
              "colors": n_colors, "launches": launches,
              "stdout": stdout.getvalue().strip()[:200]})
        if not ok:
            failures.append(f"cli {name}: rc {rc}, {n_colors} colours, launches {launches}")
    reset_launch_counts()
    t0 = time.perf_counter()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        valid = validate_kernels()
    validate_counts = mode_counts()
    emit({"phase": "cli_slice", "what": "validate_kernels", "ok": valid,
          "seconds": time.perf_counter() - t0, "checks": stdout.getvalue().splitlines(),
          "launches": validate_counts})
    if not valid:
        failures.append("validate_kernels() returned False")
    emit({"phase": "cli_slice", "seconds": time.perf_counter() - t_phase, "launches": counts})
    if failures:
        raise AssertionError("cli_slice: " + "; ".join(failures))
    return {**counts, "validate_kernels": validate_counts}


# --- Streaming in row bands --------------------------------------------------

STREAM_SIZE = 12288  # the JAX package's measured streaming case (docs/perf.md:801-808)
STREAM_BANDS = (4096, 1001)  # the default; band starts off the Bayer period, a short last band
STREAM_FIND_K = 16
# reduce_pipelined's frames: (height, width), four 1080p then four 720p.
PIPE_FRAMES = ((1080, 1920),) * 4 + ((720, 1280),) * 4
STREAM_PHASES = ("host_prep", "upload", "shrink", "train", "output_pass", "readback", "unpack",
                 "host_sort")


def big_image(height: int, width: int, seed: int) -> np.ndarray:
    """`synthetic_image`'s gradient-plus-noise recipe made 1024 rows at a
    time from one seeded generator: the one-shot recipe holds about 12 GB
    of int64 temporaries at 12288x12288."""
    rng = np.random.default_rng(seed)
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    x = np.arange(width)[None, :]
    for r0 in range(0, height, 1024):
        y = np.arange(r0, min(r0 + 1024, height))[:, None]
        rgb = np.stack(np.broadcast_arrays(x * 255 // width, y * 255 // height,
                                           (x + y) * 255 // (width + height)), -1)
        noise = rng.integers(-8, 9, rgb.shape, dtype=np.int16)
        out[r0:r0 + y.shape[0], :, :3] = np.clip(rgb + noise, 0, 255)
    return out


def _differing(a: np.ndarray, b: np.ndarray) -> int:
    """Pixels of two RGBA8 images that differ (as 32-bit words)."""
    if a.shape != b.shape:
        return -1
    return int(np.count_nonzero(np.ascontiguousarray(a).view(np.uint32)
                                != np.ascontiguousarray(b).view(np.uint32)))


def _peak_bytes(call) -> tuple:
    """`(result, peak device bytes above those allocated before the call)`."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _streamed_call(what, call, counts, card, want_launches=None, peak=False) -> tuple:
    """One streamed call, its launches counted from 0 just before it (added
    to `counts`) and its seconds split into the phases of
    `utils/profiling.py`; with `peak`, its peak device bytes. Emits the
    line; returns `(result, line)`."""
    from kmeans_tpu_torch.utils.profiling import collect_phases

    phases: dict = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with collect_phases(phases):
        if peak:
            out, peak_bytes = _peak_bytes(call)
        else:
            out = call()
    seconds = time.perf_counter() - t0
    launches = mode_counts()
    for key, n in launches.items():
        counts[key] = counts.get(key, 0) + n
    line = {"phase": "streaming_slice", "call": what, "card": card, "seconds": seconds,
            "phases_s": {n: phases[n] for n in STREAM_PHASES if n in phases},
            "syncs": phases.get("_syncs", 0), "launches": launches}
    if peak:
        line["peak_device_bytes"] = peak_bytes
    if want_launches is not None and launches != want_launches:
        line["launches_expected"] = want_launches
    return out, line


def _bands(h: int, band_rows: int) -> int:
    return -(-h // band_rows)


def _band_twins(proc, image, cents, k_active, mode, band_rows, starts):
    """The bands of `image` that start at the rows `starts`, each through
    the output pass as `_quantize_bands` runs it (padded to its bucket,
    `row_offset` its first row, the operands computed once) beside its
    plain twin (`assign_packed_reference` with the same `row_offset`;
    `meld_packed_reference`, which has no row phase). Yields
    `(r0, band, kind, words, twin)`; `kind` is "indexed" or "meld"."""
    from kmeans_tpu_torch import Image
    from kmeans_tpu_torch.ops import kernels

    h, w = image.shape[:2]
    operands = None if mode == "meld" else proc._pass_operands(cents, mode, k_active)
    for r0 in starts:
        band = proc._upload_band(Image((w, h), image), r0, band_rows)
        kind, words, _ = proc._output_pass(band, cents, mode, k_active, r0, operands)
        if mode == "meld":
            twin = kernels.meld_packed_reference(band, cents, k_active)
        else:
            twin = kernels.assign_packed_reference(band, cents, operands[0], k_active, mode, r0)
        yield r0, band, kind, words, twin


def streaming_12k(card: str, counts: dict) -> list:
    """The streamed entry points on the 12288x12288 image at k = 8:
    `find_streamed` with 16 colours in three modes at both band splits,
    each equal to the whole-image bucketed `find`; `reduce_streamed` in
    three modes (dither also at 1001 rows: the strip and so the output do
    not depend on the split), `palette_streamed`, the accumulator route at
    `train_max_size=2048`; the band words against the plain twins
    (`streaming_12k_twins`); the peak device memory of `reduce_streamed`
    at 12288x12288 and 12288x6144 beside the bucketed `reduce`. Returns
    the failures."""
    from kmeans_tpu_torch import ImageProcessor, ReduceMode

    t0 = time.perf_counter()
    img = big_image(STREAM_SIZE, STREAM_SIZE, SEED + 30)
    emit({"phase": "streaming_slice", "what": "made the 12288x12288 image",
          "seconds": time.perf_counter() - t0})
    proc, bproc = ImageProcessor(device="cuda"), ImageProcessor(device="cuda", bucketing=True)
    colors = np.random.default_rng(SEED + 31).integers(0, 256, (STREAM_FIND_K, 4),
                                                       dtype=np.uint8)
    colors[:, 3] = 255
    failures = []

    def expect(mode, kernel, bands, extra=None):
        key = "meld_packed" if mode == "meld" else kernel
        want = {f"{key} cie94 exact": bands}
        if mode == "dither":
            want["dither_threshold cie94 exact"] = 1
        return {**want, **(extra or {})}

    for mode in ("replace", "dither", "meld"):
        t0 = time.perf_counter()
        whole = bproc.find(img, colors, ReduceMode(mode)).pixels
        whole_s = time.perf_counter() - t0
        for band in STREAM_BANDS:
            want = expect(mode, "assign_packed", _bands(STREAM_SIZE, band))
            out, line = _streamed_call(
                f"find_streamed 12288x12288 {STREAM_FIND_K} colours {mode} band_rows={band}",
                lambda: proc.find_streamed(img, colors, ReduceMode(mode), band), counts, card,
                want)
            line["differing_from_bucketed_find"] = _differing(out.pixels, whole)
            line["bucketed_find_seconds"] = whole_s
            emit(line)
            if line["differing_from_bucketed_find"] or "launches_expected" in line:
                failures.append(f"find_streamed {mode} band {band}: {line}")
            del out
        del whole
    outs, peak_full = {}, None
    for mode in ("replace", "dither", "meld"):
        outs[mode], line = _streamed_call(
            f"reduce_streamed 12288x12288 k=8 {mode} band_rows=4096",
            lambda: proc.reduce_streamed(K, img, ReduceMode(mode)), counts, card,
            expect(mode, "assign_packed", _bands(STREAM_SIZE, 4096)),
            peak=mode == "replace")
        px = outs[mode].pixels
        if mode == "replace":
            peak_full = line["peak_device_bytes"]
        line.update(iterations=proc.last_iterations, colors=len(unique_rgba(px)))
        emit(line)
        if (px.shape != img.shape or (mode != "meld" and line["colors"] > K)
                or "launches_expected" in line):
            failures.append(f"reduce_streamed {mode}: {line}")
    out, line = _streamed_call(
        "reduce_streamed 12288x12288 k=8 dither band_rows=1001",
        lambda: proc.reduce_streamed(K, img, ReduceMode.DITHER, 1001), counts, card,
        expect("dither", "assign_packed", _bands(STREAM_SIZE, 1001)))
    line["differing_from_band_rows_4096"] = _differing(out.pixels, outs["dither"].pixels)
    emit(line)
    if line["differing_from_band_rows_4096"] or "launches_expected" in line:
        failures.append(f"reduce_streamed dither band 1001: {line}")
    del out, outs
    pal, line = _streamed_call("palette_streamed 12288x12288 k=8",
                               lambda: proc.palette_streamed(K, img), counts, card, {})
    line["palette"] = ["#%02X%02X%02X" % tuple(c[:3]) for c in pal]
    emit(line)
    if pal.shape != (K, 4) or "launches_expected" in line:
        failures.append(f"palette_streamed: {line}")
    # train_max_size=2048: the 2048x2048 canvas (4.2M pixels) trains on the
    # weighted accumulator, one launch per Lloyd iteration.
    acc = ImageProcessor(device="cuda", train_max_size=2048)
    out, line = _streamed_call("reduce_streamed 12288x12288 k=8 replace train_max_size=2048",
                               lambda: acc.reduce_streamed(K, img), counts, card)
    want = expect("replace", "assign_packed", _bands(STREAM_SIZE, 4096),
                  {"lloyd_accumulate cie94 exact": acc.last_iterations})
    line.update(iterations=acc.last_iterations, colors=len(unique_rgba(out.pixels)))
    if line["launches"] != want:
        line["launches_expected"] = want
        failures.append(f"reduce_streamed train_max_size=2048: {line}")
    emit(line)
    del out
    failures += streaming_12k_twins(proc, img, colors, card)
    # Peak device memory: streamed at 12288x12288 (above) and 12288x6144,
    # beside the whole-image bucketed reduce of 12288x12288.
    _, line = _streamed_call("reduce_streamed 12288x6144 k=8 replace band_rows=4096",
                             lambda: proc.reduce_streamed(K, img[:STREAM_SIZE // 2]),
                             counts, card, peak=True)
    emit(line)
    _, whole_peak = _peak_bytes(lambda: bproc.reduce(K, img))
    peaks = {"reduce_streamed_12288x12288": peak_full,
             "reduce_streamed_12288x6144": line["peak_device_bytes"],
             "bucketed_reduce_12288x12288": whole_peak}
    ratio = peaks["reduce_streamed_12288x12288"] / peaks["reduce_streamed_12288x6144"]
    emit({"phase": "streaming_slice", "what": "peak device bytes above the call's start",
          "card": card, **peaks, "streamed_12288_over_6144": ratio})
    # Streaming holds one band: below the whole image, the same at both heights.
    if not (peak_full < whole_peak and abs(ratio - 1) <= 0.1):
        failures.append(f"streamed peak memory {peaks}")
    return failures


def streaming_12k_twins(proc, img, colors, card: str) -> list:
    """The band words of the 12288x12288 image against the plain twins, at
    the shapes the streamed paths launch: the first and the last band at
    `band_rows` 4096 (three full bands) and 1001 (a last band of 276 rows,
    starts off the Bayer period), in three modes, with the palette
    `reduce_streamed` trains at k = 8 and the 16 colours of
    `find_streamed`. Every word must be equal. Returns the failures."""
    from kmeans_tpu_torch import Image
    from kmeans_tpu_torch.api import _colors_to_lab
    from kmeans_tpu_torch.utils.bucketing import pad_palette_k

    t0 = time.perf_counter()
    h, w = img.shape[:2]
    palettes = {
        f"reduce k={K}": (proc._train_streamed(Image((w, h), img), K, STREAM_BANDS[0]), K),
        f"find {STREAM_FIND_K} colours": pad_palette_k(proc._upload(_colors_to_lab(colors))),
    }
    failures, lines = [], []
    for what, (cents, k_active) in palettes.items():
        for band_rows in STREAM_BANDS:
            starts = (0, (h - 1) // band_rows * band_rows)
            for mode in ("replace", "dither", "meld"):
                for r0, band, _, words, twin in _band_twins(proc, img, cents, k_active, mode,
                                                            band_rows, starts):
                    line = {"palette": what, "mode": mode, "band_rows": band_rows, "row0": r0,
                            "rows": min(band_rows, h - r0), "padded": list(band.shape[:2]),
                            "words": words.numel(),
                            "differing_words": int((words != twin).sum())}
                    lines.append(line)
                    if line["differing_words"] or words.shape != twin.shape:
                        failures.append(f"12288x12288 band words: {line}")
    emit({"phase": "streaming_slice", "what": "12288x12288 band words against the plain twins",
          "card": card, "seconds": time.perf_counter() - t0, "bands": lines})
    return failures


def streaming_checks(image, card: str, counts: dict) -> list:
    """The checks at smaller sizes: on the 4K image in bands of 1001 rows,
    each band's words against the plain twins (with the band's
    `row_offset`; meld has none) and the streamed outputs against the
    words' unpack; `find_streamed` with 2048 colours (the RGBA route, in
    dither) against the bucketed `find`; an image within the cap against
    the bucketed `reduce`; a 1920x1080 image in bands of 256 on the card
    against the CPU. Returns the failures."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import _unpack

    proc, bproc = ImageProcessor(device="cuda"), ImageProcessor(device="cuda", bucketing=True)
    failures = []
    h, w = image.shape[:2]
    band_rows = STREAM_BANDS[1]
    cents = proc._train_streamed(Image((w, h), image), K, band_rows)
    for mode in ("replace", "dither", "meld"):
        pal = None if mode == "meld" else proc._pass_operands(cents, mode, K)[1].cpu().numpy()
        plain = np.empty_like(image)
        word_diffs = []
        for r0, band, kind, words, twin in _band_twins(proc, image, cents, K, mode, band_rows,
                                                       range(0, h, band_rows)):
            bh = min(band_rows, h - r0)
            word_diffs.append(int((words != twin).sum()))
            plain[r0:r0 + bh] = _unpack(kind, twin.cpu().numpy(), band.shape[0], band.shape[1],
                                        cents.shape[0], pal)[:bh, :w]
        out, line = _streamed_call(
            f"reduce_streamed 3840x2160 k=8 {mode} band_rows={band_rows}",
            lambda: proc.reduce_streamed(K, image, ReduceMode(mode), band_rows), counts, card)
        line.update(band_words_differing_from_twins=word_diffs,
                    differing_from_plain=_differing(out.pixels, plain))
        emit(line)
        if any(word_diffs) or line["differing_from_plain"]:
            failures.append(f"band words {mode}: {line}")
    # The RGBA route past 1024 colours, dither rows offset per band.
    colors = np.random.default_rng(SEED + 32).integers(0, 256, (BIG_K, 4), dtype=np.uint8)
    colors[:, 3] = 255
    want = {"quantize_rgba cie94 exact": _bands(h, band_rows), "dither_threshold cie94 exact": 1}
    out, line = _streamed_call(f"find_streamed 3840x2160 {BIG_K} colours dither "
                               f"band_rows={band_rows}",
                               lambda: proc.find_streamed(image, colors, ReduceMode.DITHER,
                                                          band_rows), counts, card, want)
    line["differing_from_bucketed_find"] = _differing(
        out.pixels, bproc.find(image, colors, ReduceMode.DITHER).pixels)
    emit(line)
    if line["differing_from_bucketed_find"] or "launches_expected" in line:
        failures.append(f"find_streamed {BIG_K} colours: {line}")
    # Within the cap the strip is the image: equal to the bucketed reduce.
    small = synthetic_image(180, 240, seed=SEED + 33)
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
        differ = _differing(proc.reduce_streamed(K, small, mode, 37).pixels,
                            bproc.reduce(K, small, reduce_mode=mode).pixels)
        emit({"phase": "streaming_slice", "what": "no shrink against bucketed reduce",
              "size": [180, 240], "mode": mode.value, "differing_pixels": differ})
        if differ:
            failures.append(f"no-shrink reduce_streamed {mode.value}: {differ} pixels differ")
    # The card against the CPU at 1920x1080 in bands of 256. The CPU side
    # runs on one thread: the multithreaded CPU twins flip a near-tie now
    # and then from one process to the next (0 to 10 of the 589,824 pixels
    # of a 768x768 find over 6 runs, 0 with one thread), so with one thread
    # replace and dither are held to equality. Meld keeps the bar of the
    # other card_vs_cpu lines, 1 u8 step on 1e-3 of the pixels: the CPU's
    # float32 powf and cube roots differ from the card's by an ulp here and
    # there, and meld's blend carries such an ulp into its output.
    mid = synthetic_image(1080, 1920, seed=SEED + 34)
    cpu = ImageProcessor(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        same_palette = bool((proc.palette_streamed(K, mid, 256)
                             == cpu.palette_streamed(K, mid, 256)).all())
        for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
            step = np.abs(proc.reduce_streamed(K, mid, mode, 256).pixels.astype(np.int16)
                          - cpu.reduce_streamed(K, mid, mode, 256).pixels).max(-1)
            differ = int((step > 0).sum())
            emit({"phase": "card_vs_cpu", "mode": f"reduce_streamed band_rows=256 {mode.value}",
                  "pixels": 1080 * 1920, "same_palette": same_palette, "cpu_threads": 1,
                  "differing_pixels": differ, "max_channel_step": int(step.max())})
            ok = (differ <= 1e-3 * step.size and step.max() <= 1 if mode is ReduceMode.MELD
                  else differ == 0)
            if not (same_palette and ok):
                failures.append(f"reduce_streamed card vs cpu {mode.value}: {differ} differ")
    finally:
        torch.set_num_threads(threads)
    return failures


def streaming_pipelined(card: str, counts: dict) -> list:
    """`reduce_pipelined` over 8 frames (four 1920x1080, four 1280x720) on
    an unbucketed and a bucketed processor: each output equals its solo
    `reduce`; then in turns with 8 sequential `reduce` calls, median of 3
    warm runs each, and one profiled call of each (device idle share).
    Returns the failures."""
    from kmeans_tpu_torch import ImageProcessor, ReduceMode

    frames = [synthetic_image(h, w, seed=SEED + 40 + i) for i, (h, w) in enumerate(PIPE_FRAMES)]
    failures = []
    contenders = {}
    for bucketing in (False, True):
        proc = ImageProcessor(device="cuda", bucketing=bucketing)
        for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
            outs, line = _streamed_call(
                f"reduce_pipelined 8 frames k=8 {mode.value} bucketing={bucketing}",
                lambda: proc.reduce_pipelined(frames, K, mode), counts, card)
            differ = [_differing(o.pixels, proc.reduce(K, f, reduce_mode=mode).pixels)
                      for o, f in zip(outs, frames)]
            line["differing_from_solo_reduce"] = differ
            emit(line)
            if any(differ) or len(outs) != len(frames):
                failures.append(f"reduce_pipelined {mode.value} bucketing={bucketing}: {line}")
        tag = "bucketed" if bucketing else "unbucketed"
        contenders[f"reduce_pipelined, {tag}"] = (
            lambda p=proc: p.reduce_pipelined(frames, K))
        contenders[f"8 sequential reduce calls, {tag}"] = (
            lambda p=proc: [p.reduce(K, f) for f in frames])
    runs = {what: [] for what in contenders}
    for _ in range(4):
        for what, call in contenders.items():
            t0 = time.perf_counter()
            call()
            runs[what].append((time.perf_counter() - t0) * 1e3)
    for what, call in contenders.items():
        warm = runs[what][1:]
        emit({"phase": "timing", "what": f"{what}: 8 frames (4 of 1920x1080, 4 of 1280x720) "
              "at k=8 replace, median of 3 warm in turns", "card": card,
              "e2e_ms": statistics.median(warm), "e2e_ms_each": warm,
              "profile": profile_call(call, card, what)})
    return failures


def streaming_slice(image, card: str) -> dict:
    """The streaming slice (`reduce_streamed`, `palette_streamed`,
    `find_streamed`, `reduce_pipelined`), each call driven with the launch
    counts set to 0 just before it and read just after. Returns the
    launches by kernel mode summed over the phase."""
    t0 = time.perf_counter()
    counts: dict = {}
    failures = streaming_12k(card, counts)
    failures += streaming_checks(image, card, counts)
    failures += streaming_pipelined(card, counts)
    emit({"phase": "streaming_slice", "seconds": time.perf_counter() - t0, "launches": counts})
    if failures:
        raise AssertionError("streaming_slice: " + "; ".join(failures))
    return counts


# --- The native host runtime, the codec and the HTTP service ----------------

GIF_FRAMES, GIF_H, GIF_W = 24, 360, 640
GIF_K = 8
JPEG_QUALITY = 90


def runtime_probe() -> dict:
    """The host C toolchain and image libraries the runtime builds against."""
    cc = subprocess.run(["cc", "--version"], capture_output=True, text=True, timeout=60)
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60)
    return {
        "cc": cc.stdout.splitlines()[0] if cc.returncode == 0 else f"cc failed: {cc.stderr}",
        "headers": {h: Path("/usr/include", h).is_file()
                    for h in ("png.h", "jpeglib.h", "zlib.h")},
        "libraries": sorted({line.split()[0] for line in libs.stdout.splitlines()
                             if any(n in line for n in ("libpng", "libjpeg", "libz."))}),
    }


def _secs(call, reps: int = 3) -> tuple:
    """`(result, median seconds)` of `reps` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def gif_frames(seed: int = SEED) -> tuple:
    """`GIF_FRAMES` frames of `GIF_H` x `GIF_W` from the seed (the gradient
    image, each shifted and re-noised, cut to the 3-3-2 colour cube so that
    each has <= 256 colours) and each frame's delay in centiseconds."""
    from kmeans_tpu_torch import Image

    frames = []
    for i in range(GIF_FRAMES):
        px = np.roll(synthetic_image(GIF_H, GIF_W, seed + i), 16 * i, axis=1)
        px[..., :3] &= np.array([0xE0, 0xE0, 0xC0], np.uint8)
        frames.append(Image((GIF_W, GIF_H), np.ascontiguousarray(px)))
    delays = [4 + (i * 7) % 11 for i in range(GIF_FRAMES)]
    return frames, delays


def native_vs_twins(image, card: str, counts: dict) -> list:
    """The main path's host fast paths against their numpy twins on the
    card's outputs: the 4K image's native strip, and the unpack of its
    output pass in three modes (k=8, a palette trained on the card); then
    `reduce_streamed` of a 2002x12288 image in bands of 1001 rows in three
    modes (12288 is its own width bucket, so each band unpacks straight into
    its rows of the output) with the native paths and with the numpy twins
    in their place. 0 bytes may differ."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode, api
    from kmeans_tpu_torch.utils import packing

    failures = []
    proc = ImageProcessor(device="cuda")
    img = Image((WIDTH, HEIGHT), image)
    (strip, strip_s), (twin, twin_s) = (_secs(lambda: api._host_rgb(image)),
                                        _secs(lambda: np.ascontiguousarray(image[..., :3])))
    line = {"phase": "native_vs_twins", "what": f"strip {WIDTH}x{HEIGHT}", "card": card,
            "differing_bytes": int(np.count_nonzero(strip != twin)),
            "native_ms": strip_s * 1e3, "numpy_ms": twin_s * 1e3}
    emit(line)
    if line["differing_bytes"]:
        failures.append(f"native strip: {line}")
    dev = proc._upload_image(img)
    cents = proc.extract_palette_kmeans(img, K)
    for mode in ("replace", "dither", "meld"):
        reset_launch_counts()
        kind, out, pal = proc._output_pass(dev, cents, mode)
        torch.cuda.synchronize()
        for key, n in mode_counts().items():
            counts[key] = counts.get(key, 0) + n
        words = out.cpu().numpy()
        pal_np = None if pal is None else pal.cpu().numpy()
        native, native_s = _secs(lambda: api._unpack(kind, words, HEIGHT, WIDTH, K, pal_np))
        if kind == "indexed":
            bits, rows = api.pack_bits(K), api.quant_tile_rows(K)
            twin, twin_s = _secs(lambda: packing._unpack_tile_words_gather_np(
                words, HEIGHT, WIDTH, bits, pal_np, rows))
        else:
            twin, twin_s = _secs(lambda: packing._unpack_rgb24_np(
                words, HEIGHT, WIDTH, api.quant_tile_rows(K)))
        line = {"phase": "native_vs_twins", "what": f"unpack {WIDTH}x{HEIGHT} k={K} {mode}",
                "card": card, "kind": kind,
                "differing_bytes": int(np.count_nonzero(native != twin)),
                "native_ms": native_s * 1e3, "numpy_ms": twin_s * 1e3}
        emit(line)
        if line["differing_bytes"]:
            failures.append(f"native unpack {mode}: {line}")
    band_img = Image((STREAM_SIZE, 2002), big_image(2002, STREAM_SIZE, SEED + 5))
    saved = (api.unpack_tile_words_gather, api.unpack_rgb24_tile_words, api._host_rgb)

    def twins():
        api.unpack_tile_words_gather = (
            lambda words, h, w, bits, pal, tile_rows, out=None: _fill(
                packing._unpack_tile_words_gather_np(words, h, w, bits, pal, tile_rows), out))
        api.unpack_rgb24_tile_words = (lambda words, h, w, tile_rows, out=None: _fill(
            packing._unpack_rgb24_np(words, h, w, tile_rows), out))
        api._host_rgb = lambda px: np.ascontiguousarray(np.asarray(px)[..., :3])

    for mode in ("replace", "dither", "meld"):
        reset_launch_counts()
        t0 = time.perf_counter()
        native = proc.reduce_streamed(K, band_img, ReduceMode(mode), band_rows=1001).pixels
        native_s = time.perf_counter() - t0
        for key, n in mode_counts().items():
            counts[key] = counts.get(key, 0) + n
        try:
            twins()
            t0 = time.perf_counter()
            twin = proc.reduce_streamed(K, band_img, ReduceMode(mode), band_rows=1001).pixels
            twin_s = time.perf_counter() - t0
        finally:
            api.unpack_tile_words_gather, api.unpack_rgb24_tile_words, api._host_rgb = saved
        line = {"phase": "native_vs_twins",
                "what": f"reduce_streamed 2002x{STREAM_SIZE} bands of 1001 k={K} {mode}",
                "card": card, "differing_bytes": int(np.count_nonzero(native != twin)),
                "native_s": native_s, "numpy_twins_s": twin_s}
        emit(line)
        if line["differing_bytes"]:
            failures.append(f"native streamed {mode}: {line}")
    return failures


def _fill(arr, out):
    if out is None:
        return arr
    out[...] = arr
    return out


def _native_png_jpeg(rgba, png: bytes, card: str) -> list:
    """The PNG and JPEG unit at 4K: decode of `png` (the pure-Python codec's
    4K PNG) against `png_py`'s, RGBA and palette encodes beside `png_py`'s,
    JPEG at `JPEG_QUALITY` both ways. Returns the failures."""
    from kmeans_tpu_torch import ImageProcessor, runtime
    from kmeans_tpu_torch.utils import imageio, png_py

    failures = []
    (native, native_s), (plain, plain_s) = (_secs(lambda: runtime.decode_png(png)),
                                            _secs(lambda: png_py.decode_png(png), 1))
    equal = native == plain and native[2] == rgba.tobytes()
    emit({"phase": "codec_slice", "what": f"decode {WIDTH}x{HEIGHT} PNG (filter 0)",
          "bytes": len(png), "card": card, "native_s": native_s, "png_py_s": plain_s,
          "rgba_equal_to_png_py": equal})
    if not equal:
        failures.append("native PNG decode differs from png_py's")
    rgba_png, rgba_s = _secs(lambda: runtime.encode_png(WIDTH, HEIGHT, rgba))
    _, py_s = _secs(lambda: png_py.encode_png(WIDTH, HEIGHT, rgba.tobytes()), 1)
    quantized = ImageProcessor(device="cuda").reduce(K, rgba)
    pal_png, pal_s = _secs(lambda: imageio.encode_png_bytes(quantized))
    _, pal_py_s = _secs(lambda: png_py.encode_png(
        WIDTH, HEIGHT, np.ascontiguousarray(quantized.pixels).tobytes()), 1)
    back = imageio.decode_image_bytes(pal_png).pixels
    ok = (runtime.decode_png(rgba_png)[2] == rgba.tobytes() and pal_png[25] == 3
          and bool((back == quantized.pixels).all()))
    emit({"phase": "codec_slice", "what": f"encode {WIDTH}x{HEIGHT} PNG", "card": card,
          "rgba_native_s": rgba_s, "rgba_png_py_s": py_s, "rgba_bytes": len(rgba_png),
          f"palette_k{K}_native_s": pal_s, f"palette_k{K}_png_py_rgba_s": pal_py_s,
          "palette_bytes": len(pal_png), "round_trips": ok})
    if not ok:
        failures.append("a native PNG encode did not round-trip")
    jpeg, jpeg_enc_s = _secs(lambda: runtime.encode_jpeg(WIDTH, HEIGHT, rgba, JPEG_QUALITY))
    decoded, jpeg_dec_s = _secs(lambda: imageio.decode_image_bytes(jpeg))
    err = np.abs(decoded.pixels.astype(np.int16) - rgba).max(-1)
    emit({"phase": "codec_slice", "what": f"JPEG {WIDTH}x{HEIGHT} quality {JPEG_QUALITY}",
          "card": card, "encode_s": jpeg_enc_s, "decode_s": jpeg_dec_s, "bytes": len(jpeg),
          "mean_abs_channel_err": float(np.abs(decoded.pixels[..., :3].astype(np.int16)
                                               - rgba[..., :3]).mean()),
          "max_channel_err": int(err.max())})
    if decoded.dimensions != (WIDTH, HEIGHT) or err.max() > 64:
        failures.append("the JPEG round trip is off")
    return failures


def codec_slice(image, card: str, workdir) -> tuple:
    """`codec_slice`: the native runtime on the card's host. The 4K image as
    the PNG `cli_slice` writes (the pure-Python codec's, filter 0): with the
    PNG and JPEG unit, native decode against `png_py`'s (equal RGBA), RGBA
    and palette encodes with both codecs, JPEG at quality 90 both ways
    (without it, where the host lacks libpng's and libjpeg's headers: the
    PNG through `png_py` both ways and JPEG's refusal); a 24-frame 640x360 GIF from
    the seed through the CLI's `reduce-gif` (frame and global palettes) and
    `find-gif`, each output frame against `reduce_images` / `palette_images`
    + `find_batch` / `find_batch` on the decoded frames (0 differing pixels,
    delays kept); the CLI's 4K `reduce -c 8` by phase; the fuzz tool at 300
    mutants, seed 42. Returns `(launches by kernel mode, the GIF's bytes)`."""
    import contextlib
    import io

    from kmeans_tpu_torch import ImageProcessor, ReduceMode, cli, runtime
    from kmeans_tpu_torch.tools.load_serve import FIND_COLORS
    from kmeans_tpu_torch.utils import imageio, png_py
    from kmeans_tpu_torch.utils.profiling import collect_phases

    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    failures = []
    counts: dict = {}
    rgba = np.ascontiguousarray(image)
    src = workdir / "smoke4k.png"
    png = png_py.encode_png(WIDTH, HEIGHT, rgba.tobytes())
    src.write_bytes(png)
    if runtime.codec_available():
        failures += _native_png_jpeg(rgba, png, card)
    else:
        # The reference's own path without its extension: PNG through
        # png_py, JPEG refused (runtime_probe says why).
        plain, plain_s = _secs(lambda: imageio.decode_image_bytes(png), 1)
        encoded, enc_s = _secs(lambda: imageio.encode_png_bytes(plain), 1)
        try:
            imageio.decode_image_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
            refusal = None
        except RuntimeError as exc:
            refusal = str(exc)
        ok = (plain.pixels.tobytes() == rgba.tobytes() and encoded == png
              and refusal == "JPEG support requires the native runtime")
        emit({"phase": "codec_slice", "what": f"{WIDTH}x{HEIGHT} PNG through png_py",
              "card": card, "native": "not built: no png.h / jpeglib.h (runtime_probe)",
              "bytes": len(png), "png_py_decode_s": plain_s, "png_py_encode_s": enc_s,
              "round_trips": ok, "jpeg": refusal})
        if not ok:
            failures.append("the PNG path without the native unit is off")

    frames, delays = gif_frames()
    gif = imageio.encode_gif_bytes(frames, delays=delays)
    gif_path = workdir / "anim.gif"
    gif_path.write_bytes(gif)
    decoded_frames, got_delays = imageio.decode_gif_bytes(gif, with_delays=True)
    same = got_delays == delays and all((a.pixels == b.pixels).all()
                                        for a, b in zip(decoded_frames, frames))
    emit({"phase": "codec_slice", "what": f"GIF {GIF_FRAMES}x{GIF_W}x{GIF_H}", "card": card,
          "bytes": len(gif), "round_trips": bool(same)})
    if not same:
        failures.append("the GIF did not round-trip")
    proc = ImageProcessor(device="cuda")
    colors = "#" + FIND_COLORS.replace(",", ",#")
    gif_calls = (
        ("reduce-gif frame", ["reduce-gif", "-c", str(GIF_K)],
         lambda: proc.reduce_images(decoded_frames, GIF_K, ReduceMode.REPLACE)),
        ("reduce-gif global", ["reduce-gif", "-c", str(GIF_K), "--palette-mode", "global"],
         lambda: proc.find_batch(decoded_frames, proc.palette_images(decoded_frames, GIF_K),
                                 ReduceMode.REPLACE)),
        ("find-gif dither", ["find-gif", "-p", colors, "-m", "dither"],
         lambda: proc.find_batch(decoded_frames, cli.parse_colors(colors), ReduceMode.DITHER)),
    )
    for name, argv, direct in gif_calls:
        out = workdir / f"out-{name.replace(' ', '-')}.gif"
        phases: dict = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        with collect_phases(phases):
            rc = cli.main(argv[:1] + ["-i", str(gif_path), "-o", str(out)] + argv[1:])
        seconds = time.perf_counter() - t0
        launches = mode_counts()
        for key, n in launches.items():
            counts[key] = counts.get(key, 0) + n
        got, got_delays = imageio.load_gif(str(out), with_delays=True)
        want = direct()
        differing = sum(_differing(a.pixels, b.pixels) for a, b in zip(got, want))
        line = {"phase": "codec_slice", "call": f"cli {name}", "card": card, "rc": rc,
                "seconds": seconds, "phases_ms": {n: v * 1e3 for n, v in phases.items()
                                                  if n != "_syncs"},
                "frames": len(got), "differing_pixels": differing,
                "delays_kept": got_delays == delays, "launches": launches}
        emit(line)
        if rc or len(got) != GIF_FRAMES or differing or got_delays != delays or not launches:
            failures.append(f"codec_slice {name}: {line}")

    out = workdir / "cli-reduce.png"
    phases = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with collect_phases(phases), contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["reduce", "-i", str(src), "-c", str(K), "-o", str(out)])
    seconds = time.perf_counter() - t0
    launches = mode_counts()
    for key, n in launches.items():
        counts[key] = counts.get(key, 0) + n
    got = imageio.load_image(out).pixels
    want = ImageProcessor(device="cuda").reduce(K, imageio.load_image(src)).pixels
    decode_s, encode_s = phases.get("decode", 0.0), phases.get("encode", 0.0)
    line = {"phase": "codec_slice", "call": f"cli reduce -c {K} {WIDTH}x{HEIGHT}", "card": card,
            "rc": rc, "seconds": seconds, "decode_s": decode_s, "encode_s": encode_s,
            "rest_s": seconds - decode_s - encode_s, "output_bytes": out.stat().st_size,
            "equal_to_api": bool((got == want).all()), "launches": launches}
    emit(line)
    if rc or not line["equal_to_api"] or not launches:
        failures.append(f"codec_slice cli reduce: {line}")

    t0 = time.perf_counter()
    fuzz = subprocess.run([sys.executable, "-m", "kmeans_tpu_torch.tools.fuzz_codec", "300",
                           "42"], capture_output=True, text=True, timeout=600)
    tail = fuzz.stdout.strip().splitlines()[-1:] or [fuzz.stderr[-300:]]
    emit({"phase": "codec_slice", "what": "fuzz_codec 300 42", "rc": fuzz.returncode,
          "seconds": time.perf_counter() - t0, "result": tail[0]})
    if fuzz.returncode != 0:
        failures.append(f"fuzz_codec: {fuzz.stdout[-500:]} {fuzz.stderr[-500:]}")
    emit({"phase": "codec_slice", "seconds": time.perf_counter() - t_phase, "launches": counts})
    if failures:
        raise AssertionError("codec_slice: " + "; ".join(failures))
    return counts, gif


def _http(addr, method: str, path: str, body: bytes = b"") -> tuple:
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request(method, path, body=body if method == "POST" else None)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _bomb_gif() -> bytes:
    """A GIF of a 65535x65535 screen in 33 bytes (the reference's test)."""
    import struct

    h = b"GIF89a" + struct.pack("<HH", 65535, 65535) + bytes([0x00, 0, 0])
    desc = b"\x2c" + struct.pack("<HHHH", 0, 0, 1, 1) + bytes([0x80])
    return h + desc[:10] + bytes(6) + desc[10:] + bytes([2, 1, 0x44, 0]) + b"\x3b"


def serving_slice(card: str, gif: bytes) -> dict:
    """`serving_slice`: `kmeans_tpu_torch.serve` in this process on the card,
    over `ImageProcessor(bucketing=True)` warmed as `--warmup
    1920x1080,1280x720 --warmup-k 8` does. The `docs/serving.md` traffic
    through `tools/load_serve.py`: 8 clients x 3 requests of 320x240 at k=8
    on /reduce, /find (16 colours), /palette and mixed, at windows 0 and 25
    ms; 4 clients x 2 /reduce of a 1920x1080 PNG and one JPEG; /reduce-gif
    (frame, global) and /find-gif on the 24-frame GIF; /healthz, /stats and
    the deep probe; the dimension-bomb GIF (400, "decode limit"); and
    backpressure at `max_pending=2` with 8 concurrent clients (only 200s and
    503s, each 503 with Retry-After, none pending after). Every 200 is
    decoded and held to the processor's direct call on the same image, and
    each run's launches are counted from 0 just before it. Returns the
    launches by kernel mode."""
    import threading

    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.cli import palette_hex
    from kmeans_tpu_torch.runtime import codec_available, encode_jpeg
    from kmeans_tpu_torch.serve import create_server
    from kmeans_tpu_torch.tools import load_serve
    from kmeans_tpu_torch.utils.bucketing import bucket_frames
    from kmeans_tpu_torch.utils.imageio import (
        decode_gif_bytes,
        decode_image_bytes,
        encode_png_bytes,
    )

    t_phase = time.perf_counter()
    torch.cuda.set_sync_debug_mode(0)  # process-wide: off while handler threads run
    failures = []
    counts: dict = {}

    def add(launches):
        for key, n in launches.items():
            counts[key] = counts.get(key, 0) + n

    proc = ImageProcessor(device="cuda", bucketing=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    n_warm = proc.warmup([(1920, 1080), (1280, 720)], [8],
                         batch_sizes=sorted({bucket_frames(n) for n in range(2, 17)}))
    emit({"phase": "serving_slice", "what": "warmup 1920x1080,1280x720 k=8 + batch buckets",
          "card": card, "calls": n_warm, "seconds": time.perf_counter() - t0,
          "launches": mode_counts()})
    add(mode_counts())

    def check_png(data, want_pixels):
        got = decode_image_bytes(data).pixels
        return _differing(got, want_pixels)

    body = encode_png_bytes(load_serve.workload_image(320, 240))
    img = decode_image_bytes(body)
    load_serve.warm(proc, body, "mixed", 8)
    want = {
        "/reduce?k=8": proc.reduce(8, img).pixels,
        f"/find?colors={load_serve.FIND_COLORS}":
            proc.find(img, load_serve.find_palette(), ReduceMode.REPLACE).pixels,
        "/palette?k=8": palette_hex(proc.palette(8, img)),
    }
    bodies = {}
    for endpoint in ("reduce", "find", "palette", "mixed"):
        for window in (0.0, 0.025):
            responses: list = []
            reset_launch_counts()
            result = load_serve.run(proc, window, body, 8, 3, endpoint, 8, responses=responses)
            launches = mode_counts()
            add(launches)
            bad = 0
            for path, status, _, data in responses:
                if status != 200:
                    bad += 1
                elif path.startswith("/palette"):
                    bad += json.loads(data)["palette"] != want[path].split(",")
                else:
                    bad += check_png(data, want[path]) != 0
                bodies.setdefault((path, window), set()).add(data)
            line = {"phase": "serving_slice", "what": f"8 clients x 3 320x240 k=8 /{endpoint}",
                    "card": card, **result, "responses_unlike_direct_call": bad,
                    "launches": launches}
            emit(line)
            if bad or len(responses) != 24:
                failures.append(f"serving {endpoint} window {window}: {bad} bad responses")
    batched_equal = all(bodies[(p, 0.025)] == bodies[(p, 0.0)] for p, w in bodies if w == 0.0)
    emit({"phase": "serving_slice", "what": "batched responses equal window 0's",
          "equal": batched_equal})
    if not batched_equal:
        failures.append("batched responses differ from window 0's")

    big = synthetic_image(1080, 1920, SEED + 9)
    big_png = encode_png_bytes(Image((1920, 1080), big))
    want_big = proc.reduce(8, Image((1920, 1080), big)).pixels
    responses = []
    reset_launch_counts()
    result = load_serve.run(proc, 0.025, big_png, 4, 2, "reduce", 8, responses=responses)
    launches = mode_counts()
    add(launches)
    bad = sum(s != 200 or check_png(d, want_big) != 0 for _, s, _, d in responses)
    emit({"phase": "serving_slice", "what": "4 clients x 2 1920x1080 k=8 /reduce", "card": card,
          **result, "body_bytes": len(big_png), "responses_unlike_direct_call": bad,
          "launches": launches})
    if bad:
        failures.append(f"serving 1080p: {bad} bad responses")

    srv = create_server(port=0, processor=proc, batch_window_s=0.025)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    try:
        if codec_available():
            jpeg = encode_jpeg(1920, 1080, big, JPEG_QUALITY)
            reset_launch_counts()
            t0 = time.perf_counter()
            status, _, data = _http(addr, "POST", "/reduce?k=8&mode=dither", jpeg)
            seconds = time.perf_counter() - t0
            launches = mode_counts()
            add(launches)
            differing = check_png(data, proc.reduce(8, decode_image_bytes(jpeg),
                                                    reduce_mode=ReduceMode.DITHER).pixels)
            emit({"phase": "serving_slice", "card": card, "status": status,
                  "what": "/reduce?k=8&mode=dither of a 1920x1080 JPEG", "seconds": seconds,
                  "differing_pixels": differing, "launches": launches})
            if status != 200 or differing:
                failures.append(f"serving JPEG: status {status}, {differing} pixels differ")
        else:
            # Without the PNG and JPEG unit a JPEG body is refused as the
            # reference refuses it without its extension.
            status, _, data = _http(addr, "POST", "/reduce?k=8",
                                    b"\xff\xd8\xff\xe0" + bytes(64))
            emit({"phase": "serving_slice", "what": "/reduce?k=8 of a JPEG body", "card": card,
                  "native": "not built: no png.h / jpeglib.h (runtime_probe)",
                  "status": status, "body": data.decode().strip()})
            if status != 400 or b"JPEG support requires the native runtime" not in data:
                failures.append(f"serving JPEG refusal: {status} {data[:200]}")

        frames, delays = decode_gif_bytes(gif, with_delays=True)
        gif_calls = (
            (f"/reduce-gif?k={GIF_K}", lambda: proc.reduce_images(frames, GIF_K)),
            (f"/reduce-gif?k={GIF_K}&palette_mode=global",
             lambda: proc.find_batch(frames, proc.palette_images(frames, GIF_K),
                                     ReduceMode.REPLACE)),
            (f"/find-gif?colors={load_serve.FIND_COLORS}&mode=dither",
             lambda: proc.find_batch(frames, load_serve.find_palette(), ReduceMode.DITHER)),
        )
        for path, direct in gif_calls:
            reset_launch_counts()
            t0 = time.perf_counter()
            status, headers, data = _http(addr, "POST", path, gif)
            seconds = time.perf_counter() - t0
            launches = mode_counts()
            add(launches)
            got, got_delays = decode_gif_bytes(data, with_delays=True)
            differing = sum(_differing(a.pixels, b.pixels) for a, b in zip(got, direct()))
            line = {"phase": "serving_slice", "what": f"{path} {GIF_FRAMES}x{GIF_W}x{GIF_H}",
                    "card": card, "status": status, "seconds": seconds, "frames": len(got),
                    "differing_pixels": differing, "delays_kept": got_delays == delays,
                    "launches": launches}
            emit(line)
            if status != 200 or len(got) != GIF_FRAMES or differing or got_delays != delays:
                failures.append(f"serving {path}: {line}")

        health = _http(addr, "GET", "/healthz")
        deep = _http(addr, "GET", "/healthz?deep=1")
        t0 = time.perf_counter()
        probe = srv.service.deep_health()
        probe_s = time.perf_counter() - t0
        bomb = _http(addr, "POST", "/reduce-gif?k=2", _bomb_gif())
        stats = _http(addr, "GET", "/stats")
        stats_json = json.loads(stats[2])
        line = {"phase": "serving_slice", "what": "health, stats, bomb", "card": card,
                "healthz": [health[0], health[2].decode().strip()],
                "deep": [deep[0], deep[2].decode().strip()], "deep_health": list(probe),
                "deep_health_s": probe_s, "bomb": [bomb[0], bomb[2].decode().strip()[:120]],
                "stats_endpoints": sorted(stats_json["endpoints"])}
        emit(line)
        if (health != (200, health[1], b"ok\n") or deep[0] != 200 or probe != (True, "ok")
                or bomb[0] != 400 or b"decode limit" not in bomb[2] or stats[0] != 200):
            failures.append(f"serving health/stats/bomb: {line}")
    finally:
        srv.shutdown()
        srv.server_close()

    responses = []
    reset_launch_counts()
    result = load_serve.run(proc, 0.025, big_png, 8, 1, "reduce", 8, max_pending=2,
                            responses=responses)
    launches = mode_counts()
    add(launches)
    statuses = sorted({s for _, s, _, _ in responses})
    retry = all("Retry-After" in h for _, s, h, _ in responses if s == 503)
    bad = sum(check_png(d, want_big) != 0 for _, s, _, d in responses if s == 200)
    line = {"phase": "serving_slice", "what": "backpressure max_pending=2, 8 clients 1920x1080",
            "card": card, **result, "statuses": statuses, "retry_after_on_503": retry,
            "responses_unlike_direct_call": bad, "launches": launches}
    emit(line)
    if statuses != [200, 503] or not retry or bad or result["pending_after"] != 0:
        failures.append(f"serving backpressure: {line}")
    emit({"phase": "serving_slice", "seconds": time.perf_counter() - t_phase, "launches": counts})
    if failures:
        raise AssertionError("serving_slice: " + "; ".join(failures))
    return counts


# --- Multi-device sharding ---------------------------------------------------

SHARD_MESHES = (1, 2, 4)  # pixel-axis shards, each a repeat of the one card
SHARD_ODD_H = 2161  # rows that pad to the shard count
SHARD_FIND_K = 16
SHARD_BIG_K = 2048  # past INDEXED_MAX_K: colour out a shard
SHARD_PALETTE_STEP = 2  # the reference's own bars (tests/test_distributed.py:680-683, 717)
SHARD_EQUAL_SHARE = 0.999
SHARD_OCTREE_FRAMES = 2  # the host octree's fallback: ~0.9 s a 1080p frame


def _sharded_call(what, call, counts, card, want=None) -> tuple:
    """One sharded call with the launch counts set to 0 just before it and
    read just after (added to `counts`); `want` maps a kernel-mode key to
    the launches the call must make. Returns `(result, line, failure)`."""
    import torch

    reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mode_counts()
    for key, n in launches.items():
        counts[key] = counts.get(key, 0) + n
    line = {"phase": "sharding_slice", "call": what, "card": card, "seconds": seconds,
            "launches": launches}
    bad = {key: (launches.get(key, 0), n) for key, n in (want or {}).items()
           if launches.get(key, 0) != n}
    if bad:
        line["launches_expected"] = want
    return out, line, (f"{what}: launches (got, want) {bad}" if bad else None)


def _palette_step(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return 256
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def sharding_words_vs_twins(image, card: str) -> list:
    """Each shard's words against the twins on its own rows with its own
    `row_offset`: the 4K image and its 2161-row crop on 4 shards (dither
    and meld, 16 colours), and k=2048 colour out on 2 shards. These
    launches compare kernels with twins and count for no path."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.parallel.sharded_ops import _assign_words, _meld_words, _row_sharded

    failures = []
    device = torch.device("cuda", 0)
    odd = synthetic_image(SHARD_ODD_H, WIDTH, seed=SEED + 45)
    cases = [(image, 4, SHARD_FIND_K, "dither"), (odd, 4, SHARD_FIND_K, "dither"),
             (odd, 4, SHARD_FIND_K, "meld"), (image, 2, SHARD_BIG_K, "replace")]
    for img, d, k, mode in cases:
        mesh = make_mesh([device] * d)
        pal = random_palette_lab(k, SEED + 40 + k, device)
        blocks, h, local_h = _row_sharded(mesh, np.ascontiguousarray(img[..., :3]))
        if mode == "meld":
            got = _meld_words(blocks, pal, None, "cie94", False)
            want = [kernels.meld_packed_reference(b, pal) for b in blocks]
        else:
            got = _assign_words(blocks, local_h, pal, mode, None, "cie94", False,
                                colour_out=k > kernels.INDEXED_MAX_K)
            thr = dither_threshold(pal) if mode == "dither" else 0.0
            twin = (kernels.quantize_rgba_reference if k > kernels.INDEXED_MAX_K
                    else kernels.assign_packed_reference)
            want = [twin(b, pal, thr, mode=mode, row_offset=s * local_h)
                    for s, b in enumerate(blocks)]
        torch.cuda.synchronize()
        mism = [int((g != w).sum()) for g, w in zip(got, want)]
        line = {"phase": "sharding_words_vs_twins", "h": h, "w": img.shape[1], "shards": d,
                "local_h": local_h, "k": k, "mode": mode, "card": card,
                "mismatched_per_shard": mism}
        emit(line)
        if any(mism):
            failures.append(f"sharded words vs twins: {line}")
    return failures


def sharding_outputs(image, card: str, counts: dict) -> list:
    """`find_sharded` against `find` (bit for bit) on 1, 2 and 4 shards in
    three modes, on 2161 rows, and at k=2048; `reduce_sharded` on the shrunk
    and the full-resolution training, CIEDE2000, the k=600 row-chunked
    route and the bucketed one; `palette_sharded`; the seeds against the
    single-device seeds. A one-shard mesh must give the single-device
    pixels; 2 and 4 shards palettes within 2 u8 and 0.999 of the pixels."""
    import torch

    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.resize import resize_uint8, shrunk_dimensions
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.parallel.distributed import seed_sharded

    failures = []
    device = torch.device("cuda", 0)
    meshes = {d: make_mesh([device] * d) for d in SHARD_MESHES}
    proc = ImageProcessor(device="cuda")
    rng = np.random.default_rng(SEED + 41)
    colors = rng.integers(0, 256, (SHARD_FIND_K, 4), dtype=np.uint8)
    colors[:, 3] = 255
    big = rng.integers(0, 256, (SHARD_BIG_K, 4), dtype=np.uint8)
    big[:, 3] = 255

    def run(what, call, want=None):
        out, line, bad = _sharded_call(what, call, counts, card, want)
        if bad:
            failures.append(bad)
        return out, line

    # The output pass: find_sharded against find, bit for bit.
    odd = synthetic_image(SHARD_ODD_H, WIDTH, seed=SEED + 45)
    cases = [(image, colors, m, d) for m in ("replace", "dither", "meld") for d in SHARD_MESHES]
    cases += [(odd, colors, m, 4) for m in ("dither", "meld")]
    cases += [(image, big, "replace", 2)]
    singles = {}
    for img, cols, mode, d in cases:
        key = (img.shape[0], cols.shape[0], mode)
        if key not in singles:
            singles[key] = proc.find(img, cols, ReduceMode(mode)).pixels
        kernel = ("meld_packed cie94 exact" if mode == "meld" else
                  "quantize_rgba cie94 exact" if cols.shape[0] > SHARD_FIND_K else
                  "assign_packed cie94 exact")
        want = {kernel: d}
        if mode == "dither":
            want["dither_threshold cie94 exact"] = 1
        out, line = run(f"find_sharded {img.shape[0]}x{img.shape[1]} k={cols.shape[0]} {mode} "
                        f"shards={d}",
                        lambda: proc.find_sharded(img, cols, ReduceMode(mode), mesh=meshes[d]),
                        want)
        line["differing_pixels_vs_find"] = _differing(out.pixels, singles[key])
        emit(line)
        if line["differing_pixels_vs_find"]:
            failures.append(f"find_sharded: {line}")

    # The seeds: the shrunk store and the full-resolution one.
    sw, sh = shrunk_dimensions(WIDTH, HEIGHT, 256)
    dev = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(device)
    for name, store, first in (
            ("shrunk", srgb8_to_lab(resize_uint8(dev, sh, sw).reshape(-1, 3)),
             km.reference_seed_index(sw, sh)),
            ("full resolution", srgb8_to_lab(dev.reshape(-1, 3)),
             km.reference_seed_index(WIDTH, HEIGHT))):
        want = km.plusplus_init(store, K, first)
        for d in SHARD_MESHES:
            same = bool(torch.equal(seed_sharded(meshes[d], store, None, K, first), want))
            emit({"phase": "sharding_seeds", "store": name, "shards": d, "equal": same})
            if not same:
                failures.append(f"sharded seeds {name} shards={d} differ")

    # Training: each reduce_sharded against reduce.
    full = ImageProcessor(device="cuda", train_max_size=None)
    proc2000 = ImageProcessor(device="cuda", delta_e="2000")
    bproc = ImageProcessor(device="cuda", bucketing=True)
    mid = synthetic_image(600, 640, seed=SEED + 33)
    portrait = synthetic_image(1350, 1080, seed=SEED + 42)
    runs = [(proc, image, m, d, "shrunk") for m in ("replace", "dither", "meld")
            for d in SHARD_MESHES]
    runs += [(full, image, "replace", d, "full resolution") for d in SHARD_MESHES]
    runs += [(proc2000, image, "replace", 2, "delta_e=2000"),
             (full, mid, "replace", 2, "k=600 row-chunked"),
             (bproc, portrait, "replace", 2, "bucketed"), (bproc, portrait, "dither", 4,
                                                           "bucketed")]
    singles = {}
    for p, img, mode, d, what in runs:
        k = 600 if img is mid else K
        if (id(p), id(img), mode) not in singles:
            singles[id(p), id(img), mode] = p.reduce(k, img, reduce_mode=ReduceMode(mode)).pixels
        metric = "cie2000" if p is proc2000 else "cie94"
        want = {f"{'meld' if mode == 'meld' else 'assign'}_packed {metric} exact": d}
        if mode == "dither":
            want[f"dither_threshold {metric} exact"] = 1
        out, line = run(f"reduce_sharded {what} {img.shape[0]}x{img.shape[1]} k={k} {mode} "
                        f"shards={d}",
                        lambda: p.reduce_sharded(k, img, ReduceMode(mode), mesh=meshes[d]), want)
        acc = sum(n for key, n in line["launches"].items() if key.startswith("lloyd_accumulate"))
        line.update(iterations=p.last_iterations, lloyd_accumulate_launches=acc,
                    equal_share_vs_reduce=_pixels_equal(out.pixels, singles[id(p), id(img), mode]),
                    differing_pixels_vs_reduce=_differing(out.pixels,
                                                          singles[id(p), id(img), mode]))
        emit(line)
        if acc != (d * p.last_iterations if what == "full resolution" else 0):
            failures.append(f"{line['call']}: {acc} accumulator launches, "
                            f"{d} shards x {p.last_iterations} iterations")
        if d == 1 and line["differing_pixels_vs_reduce"]:
            failures.append(f"one-shard mesh differs from reduce: {line}")
        if line["equal_share_vs_reduce"] < SHARD_EQUAL_SHARE:
            failures.append(f"reduce_sharded below the bar: {line}")
    # palette_sharded on both trainings; the same mesh twice gives the same bits.
    for p, d, what in ((proc, 4, "shrunk"), (full, 2, "full resolution"),
                       (full, 4, "full resolution")):
        pal, line = run(f"palette_sharded {what} k=8 shards={d}",
                        lambda: p.palette_sharded(K, image, mesh=meshes[d]))
        line["max_u8_step_vs_palette"] = _palette_step(pal, p.palette(K, image))
        emit(line)
        if line["max_u8_step_vs_palette"] > SHARD_PALETTE_STEP:
            failures.append(f"palette_sharded: {line}")
    again = proc.reduce_sharded(K, image, mesh=meshes[4]).pixels
    twice = proc.reduce_sharded(K, image, mesh=meshes[4]).pixels
    emit({"phase": "sharding_slice", "call": "reduce_sharded shrunk k=8 shards=4, twice",
          "equal": bool(np.array_equal(again, twice))})
    if not np.array_equal(again, twice):
        failures.append("reduce_sharded on one mesh twice: outputs differ")
    return failures


def sharding_batches(card: str, counts: dict) -> list:
    """16 frames of 1920x1080: `reduce_images_sharded` at k=8 on 2x2 (data x
    pixel) against 16 `reduce` calls, `palette_images_sharded` (and its
    octree fallback) against `palette_images`, `find_batch_sharded` in three
    modes against `find_batch` (bit for bit)."""
    import torch

    from kmeans_tpu_torch import Algorithm, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.parallel import make_mesh

    failures = []
    device = torch.device("cuda", 0)
    mesh22 = make_mesh([device] * 4, data=2)
    mesh4 = make_mesh([device] * 4)
    proc = ImageProcessor(device="cuda")
    frames = frames_rgba(SEED + 10)
    rng = np.random.default_rng(SEED + 43)
    colors = rng.integers(0, 256, (SHARD_FIND_K, 4), dtype=np.uint8)
    colors[:, 3] = 255

    def run(what, call, want=None):
        out, line, bad = _sharded_call(what, call, counts, card, want)
        if bad:
            failures.append(bad)
        return out, line

    outs, line = run("reduce_images_sharded 16x1920x1080 k=8 replace 2x2",
                     lambda: proc.reduce_images_sharded(frames, K, mesh=mesh22),
                     {"assign_packed cie94 exact": 2 * len(frames)})
    singles = [proc.reduce(K, f).pixels for f in frames]
    line["equal_share_vs_reduce"] = min(_pixels_equal(o.pixels, s)
                                        for o, s in zip(outs, singles))
    emit(line)
    if line["equal_share_vs_reduce"] < SHARD_EQUAL_SHARE:
        failures.append(f"reduce_images_sharded: {line}")
    for algo, batch in ((Algorithm.KMEANS, frames),
                        (Algorithm.OCTREE, frames[:SHARD_OCTREE_FRAMES])):
        pal, line = run(f"palette_images_sharded {len(batch)}x1920x1080 k=8 {algo.value} "
                        "shards=4",
                        lambda: proc.palette_images_sharded(batch, K, algo, mesh=mesh4))
        line["max_u8_step_vs_palette_images"] = _palette_step(
            pal, proc.palette_images(batch, K, algo))
        emit(line)
        if line["max_u8_step_vs_palette_images"] > (SHARD_PALETTE_STEP
                                                    if algo is Algorithm.KMEANS else 0):
            failures.append(f"palette_images_sharded: {line}")
    for mode in ("replace", "dither", "meld"):
        kernel = "meld_packed cie94 exact" if mode == "meld" else "assign_packed cie94 exact"
        want = {kernel: 4, **({"dither_threshold cie94 exact": 1} if mode == "dither" else {})}
        outs, line = run(f"find_batch_sharded 16x1920x1080 k=16 {mode} shards=4",
                         lambda: proc.find_batch_sharded(frames, colors, ReduceMode(mode),
                                                         mesh=mesh4), want)
        single = proc.find_batch(frames, colors, ReduceMode(mode))
        line["differing_pixels_vs_find_batch"] = sum(_differing(o.pixels, s.pixels)
                                                     for o, s in zip(outs, single))
        emit(line)
        if line["differing_pixels_vs_find_batch"]:
            failures.append(f"find_batch_sharded: {line}")
    return failures


def sharding_card_vs_cpu(card: str) -> list:
    """A 2-shard `reduce_sharded` of 320x240 on the card and on the CPU:
    the same palette, at most 1e-4 of the pixels apart."""
    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.parallel import make_mesh

    failures = []
    small = synthetic_image(240, 320, seed=SEED + 44)
    on = {dev: ImageProcessor(device=dev) for dev in ("cuda", "cpu")}
    meshes = {"cuda": make_mesh(["cuda:0"] * 2), "cpu": make_mesh(["cpu"] * 2)}
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
        outs = {dev: p.reduce_sharded(K, small, mode, mesh=meshes[dev]).pixels
                for dev, p in on.items()}
        pals = {dev: p.palette_sharded(K, small, mesh=meshes[dev]) for dev, p in on.items()}
        line = {"phase": "sharding_card_vs_cpu", "mode": mode.value, "pixels": 240 * 320,
                "differing_pixels": _differing(outs["cuda"], outs["cpu"]),
                "same_palette": bool(np.array_equal(pals["cuda"], pals["cpu"]))}
        emit(line)
        if not line["same_palette"] or line["differing_pixels"] > 240 * 320 // 10000:
            failures.append(f"sharding card vs cpu: {line}")
    return failures


def time_sharded(image, card: str) -> None:
    """4K k=8 replace: `reduce` against `reduce_sharded` on 1, 2 and 4
    shards of the one card, median of 5 warm runs in turns, by phase. The
    shards share one device, so this is the protocol's cost, not scaling."""
    from kmeans_tpu_torch import ImageProcessor
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.utils.profiling import collect_phases

    proc = ImageProcessor(device="cuda")
    calls = {"reduce": lambda: proc.reduce(K, image)}
    for d in SHARD_MESHES:
        mesh = make_mesh(["cuda:0"] * d)
        calls[f"reduce_sharded shards={d}"] = lambda mesh=mesh: proc.reduce_sharded(
            K, image, mesh=mesh)
    runs = {what: [] for what in calls}
    for _ in range(6):
        for what, call in calls.items():
            phases: dict = {}
            t0 = time.perf_counter()
            with collect_phases(phases):
                call()
            runs[what].append((time.perf_counter() - t0, phases))
    for what, rows in runs.items():
        warm = rows[1:]
        emit({"phase": "timing", "what": f"{what} 3840x2160 k=8 replace, median of 5 warm, in "
                                          "turns; shards share one card: protocol cost, "
                                          "not scaling",
              "card": card, "e2e_ms": statistics.median(r[0] for r in warm) * 1e3,
              "e2e_ms_each": [r[0] * 1e3 for r in warm],
              "phases_ms": {name: statistics.median(r[1].get(name, 0.0) for r in warm) * 1e3
                            for name in ("host_prep", "upload", "device", "lloyd_sync",
                                         "readback", "unpack")},
              "syncs": statistics.median(r[1].get("_syncs", 0) for r in warm)})


def sharding_slice(image, card: str) -> dict:
    """The sharded entry points on meshes of 1, 2 and 4 shards of the one
    card (and 2x2 for the batches), each call driven with the launch counts
    set to 0 just before it and read just after; the shards' words against
    the twins; the card against the CPU; the times. Returns the launches by
    kernel mode summed over the phase's driven calls."""
    t0 = time.perf_counter()
    counts: dict = {}
    failures = sharding_outputs(image, card, counts)
    failures += sharding_batches(card, counts)
    failures += sharding_words_vs_twins(image, card)
    failures += sharding_card_vs_cpu(card)
    time_sharded(image, card)
    emit({"phase": "sharding_slice", "seconds": time.perf_counter() - t0, "launches": counts})
    if failures:
        raise AssertionError("sharding_slice: " + "; ".join(failures))
    return counts


# --- Pipeline mode ----------------------------------------------------------

PIPE_K = 8
PIPE_ROUNDS = 6  # the first of each contender's runs is its warm-up
PIPE_PHASES = ("host_prep", "upload", "device", "lloyd_sync", "readback", "unpack")


def _upload_bytes(call) -> tuple:
    """`(result, bytes that ImageProcessor._upload moved)` of one call."""
    from kmeans_tpu_torch import ImageProcessor

    moved = []
    inner = ImageProcessor._upload

    def upload(self, array):
        moved.append(int(np.asarray(array).nbytes))
        return inner(self, array)

    ImageProcessor._upload = upload
    try:
        return call(), sum(moved)
    finally:
        ImageProcessor._upload = inner


def _in_turns(contenders: dict, rounds: int = PIPE_ROUNDS, phases: bool = False) -> dict:
    """For each `what -> call`, the host-clock milliseconds of `rounds`
    runs in turns, each ending in a device sync; with `phases`, each run
    records the phases of `utils/profiling.py` (whose syncs serialize
    the bands' overlap). Returns `what -> [(ms, phases)]`."""
    import torch

    from kmeans_tpu_torch.utils.profiling import collect_phases

    runs = {what: [] for what in contenders}
    for _ in range(rounds):
        for what, call in contenders.items():
            acc: dict = {}
            t0 = time.perf_counter()
            if phases:
                with collect_phases(acc):
                    call()
            else:
                call()
            torch.cuda.synchronize()
            runs[what].append(((time.perf_counter() - t0) * 1e3, acc))
    return runs


def pipeline_checks(image, card: str, counts: dict) -> list:
    """Pipeline mode on the 4K image at k = 8: the host strip against the
    device shrink (bytes apart); the palette against `pipeline=False`
    (channels apart) and the card's against the CPU's (equal: the same
    strip bytes); the banded `reduce` in replace and dither against the
    monolithic pass on the same centroids (0 pixels apart), against the
    default `reduce` (pixels apart, reported), with one assign launch a
    band and one threshold launch for dither; each band's words against
    the plain twin with its `row_offset`. Returns the failures."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import PIPELINE_BAND_ROWS
    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.resize import resize_uint8, resize_uint8_np, shrunk_dimensions

    failures = []
    h, w = image.shape[:2]
    img = Image((w, h), image)
    piped, plain = ImageProcessor(device="cuda", pipeline=True), ImageProcessor(device="cuda")
    sw, sh = shrunk_dimensions(w, h, piped.train_max_size)
    rgb = np.ascontiguousarray(image[..., :3])
    host_strip = resize_uint8_np(image, sh, sw)[..., :3]
    dev_strip = resize_uint8(torch.from_numpy(rgb).cuda(), sh, sw).cpu().numpy()
    step = np.abs(host_strip.astype(np.int16) - dev_strip)
    line = {"phase": "pipeline_slice", "what": "host strip against the device shrink",
            "card": card, "strip": [sh, sw], "bytes": host_strip.size,
            "differing_bytes": int((step > 0).sum()), "max_step": int(step.max())}
    emit(line)
    if step.max() > 1:
        failures.append(f"strip: {line}")

    reset_launch_counts()
    pal, moved = _upload_bytes(lambda: piped.palette(PIPE_K, img))
    launches = mode_counts()
    plain_pal, plain_moved = _upload_bytes(lambda: plain.palette(PIPE_K, img))
    cpu_pal = ImageProcessor(device="cpu", pipeline=True).palette(PIPE_K, img)
    line = {"phase": "pipeline_slice", "what": f"palette {w}x{h} k=8", "card": card,
            "upload_bytes": moved, "upload_bytes_default": plain_moved,
            "channels_differing_from_default": int((pal != plain_pal).sum()),
            "max_channel_step_from_default": int(np.abs(pal.astype(np.int16) - plain_pal).max()),
            "equal_to_cpu": bool((pal == cpu_pal).all()), "launches": launches,
            "palette": ["#%02X%02X%02X" % tuple(c[:3]) for c in pal]}
    emit(line)
    if moved != host_strip.size or plain_moved != rgb.size or not line["equal_to_cpu"]:
        failures.append(f"palette: {line}")

    dev = torch.from_numpy(rgb).cuda()
    cents = piped.extract_palette_kmeans(img, PIPE_K)
    bands = -(-h // PIPELINE_BAND_ROWS)
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER):
        reset_launch_counts()
        banded = piped.reduce(PIPE_K, img, reduce_mode=mode).pixels
        torch.cuda.synchronize()
        launches = mode_counts()
        for key, n in launches.items():
            counts[key] = counts.get(key, 0) + n
        want = {"assign_packed cie94 exact": bands}
        if mode is ReduceMode.DITHER:
            want["dither_threshold cie94 exact"] = 1
        mono = piped._quantize(dev, cents, mode.value)
        default = plain.reduce(PIPE_K, img, reduce_mode=mode).pixels
        operands = piped._pass_operands(cents, mode.value)
        word_diffs = []
        for r0 in range(0, h, PIPELINE_BAND_ROWS):
            band = dev[r0:r0 + PIPELINE_BAND_ROWS]
            _, words, _ = piped._output_pass(band, cents, mode.value, None, r0, operands)
            twin = kernels.assign_packed_reference(band, cents, operands[0], None, mode.value, r0)
            word_diffs.append(int((words != twin).sum()) if words.shape == twin.shape else -1)
        line = {"phase": "pipeline_slice", "what": f"reduce {w}x{h} k=8 {mode.value}",
                "card": card, "bands": bands, "launches": launches,
                "differing_from_monolithic_same_centroids": _differing(banded, mono),
                "differing_from_default_reduce": _differing(banded, default),
                "band_words_differing_from_twins": word_diffs,
                "colors": len(unique_rgba(banded))}
        emit(line)
        if (launches != want or line["differing_from_monolithic_same_centroids"] or any(word_diffs)
                or line["colors"] > PIPE_K):
            failures.append(f"reduce {mode.value}: {line}")
    return failures


def pipeline_times(image, card: str) -> None:
    """4K k=8 `reduce` at `pipeline=True` against `pipeline=False` in
    replace and dither, and `palette` both ways: the median of 5 warm runs
    in turns with phases off (e2e), then 3 more in turns with phases on
    (the phases' medians), then one profiled call of each (device idle
    share)."""
    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode

    h, w = image.shape[:2]
    img = Image((w, h), image)
    procs = {True: ImageProcessor(device="cuda", pipeline=True),
             False: ImageProcessor(device="cuda")}
    contenders = {}
    for mode in (ReduceMode.REPLACE, ReduceMode.DITHER):
        for piped in (True, False):
            contenders[f"reduce {w}x{h} k=8 {mode.value} pipeline={piped}"] = (
                lambda p=procs[piped], m=mode: p.reduce(PIPE_K, img, reduce_mode=m))
    for piped in (True, False):
        contenders[f"palette {w}x{h} k=8 pipeline={piped}"] = (
            lambda p=procs[piped]: p.palette(PIPE_K, img))
    e2e = _in_turns(contenders)
    phased = _in_turns(contenders, rounds=3, phases=True)
    for what, call in contenders.items():
        warm = [ms for ms, _ in e2e[what][1:]]
        emit({"phase": "timing", "what": f"{what}, median of {len(warm)} warm in turns",
              "card": card, "e2e_ms": statistics.median(warm), "e2e_ms_each": warm,
              "phases_ms": {n: statistics.median(acc.get(n, 0.0) for _, acc in phased[what]) * 1e3
                            for n in PIPE_PHASES},
              "phased_e2e_ms": statistics.median(ms for ms, _ in phased[what]),
              "syncs": statistics.median(acc.get("_syncs", 0) for _, acc in phased[what]),
              "profile": profile_call(call, card, what)})


def pipeline_timeline(image, card: str) -> None:
    """Where one warm pipelined 4K k=8 replace `reduce` spends its wall
    time: host-clock marks (ms from the call's start) at the ends of the
    host strip (`_pipeline_strip`), of each band's alpha strip on the
    upload thread (`_host_rgb`), of the training (`_train`), of each
    output pass, and of each band's unpack on the host thread (`_unpack`),
    beside the call's end. The second of two calls is kept."""
    import threading

    import torch

    from kmeans_tpu_torch import Image, ImageProcessor, api

    marks = []
    t0 = [0.0]
    names = {"_pipeline_strip": ImageProcessor, "_output_pass": ImageProcessor,
             "_host_rgb": api, "_train": api, "_unpack": api}
    saved = {name: getattr(owner, name) for name, owner in names.items()}

    def timed(name, inner):
        def call(*args, **kwargs):
            start = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                marks.append((name, threading.current_thread() is threading.main_thread(),
                              (start - t0[0]) * 1e3, (time.perf_counter() - t0[0]) * 1e3))
        return call

    proc = ImageProcessor(device="cuda", pipeline=True)
    img = Image((image.shape[1], image.shape[0]), image)
    try:
        for name, owner in names.items():
            setattr(owner, name, timed(name, saved[name]))
        for _ in range(2):
            marks.clear()
            t0[0] = time.perf_counter()
            proc.reduce(PIPE_K, img)
            torch.cuda.synchronize()
            end_ms = (time.perf_counter() - t0[0]) * 1e3
    finally:
        for name, owner in names.items():
            setattr(owner, name, saved[name])

    def spans(name, main=None):
        return [[round(a, 3), round(b, 3)] for n, m, a, b in sorted(marks, key=lambda x: x[2])
                if n == name and (main is None or m == main)]

    emit({"phase": "timing", "what": f"timeline of one warm pipelined reduce {img.dimensions[0]}x"
          f"{img.dimensions[1]} k=8 replace, ms from its start", "card": card, "end_ms": end_ms,
          "host_strip": spans("_pipeline_strip"), "band_alpha_strips": spans("_host_rgb", False),
          "train": spans("_train"), "output_passes": spans("_output_pass"),
          "unpacks": spans("_unpack")})


def pipeline_entry_points(image, card: str, workdir, counts: dict) -> list:
    """The command line and the server under `--pipeline`: `cli.main`
    (`--pipeline reduce -c 8`) on the 4K PNG, equal to the API's call on
    the decoded image, its launches counted; `serve.main` with `--pipeline`
    (its server started in this process) answering one `/palette?k=8` of
    the 4K PNG as the bucketed pipelined processor's direct call does.
    Returns the failures."""
    import contextlib
    import io
    import signal
    import threading

    from kmeans_tpu_torch import ImageProcessor, cli, serve
    from kmeans_tpu_torch.api import PIPELINE_BAND_ROWS
    from kmeans_tpu_torch.utils import png_py
    from kmeans_tpu_torch.utils.imageio import load_image

    failures = []
    workdir.mkdir(parents=True, exist_ok=True)
    src = workdir / "pipeline4k.png"
    src.write_bytes(png_py.encode_png(image.shape[1], image.shape[0],
                                      np.ascontiguousarray(image).tobytes()))
    decoded = load_image(src)
    out = workdir / "pipeline-reduce.png"
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--pipeline", "reduce", "-i", str(src), "-c", str(PIPE_K), "-o", str(out)])
    seconds = time.perf_counter() - t0
    launches = mode_counts()
    for key, n in launches.items():
        counts[key] = counts.get(key, 0) + n
    want = ImageProcessor(device="cuda", pipeline=True).reduce(PIPE_K, decoded).pixels
    line = {"phase": "pipeline_slice", "what": "cli --pipeline reduce -c 8 of the 4K PNG",
            "card": card, "rc": rc, "seconds": seconds, "launches": launches,
            "differing_from_api": _differing(load_image(out).pixels, want)}
    emit(line)
    bands = -(-image.shape[0] // PIPELINE_BAND_ROWS)
    if rc != 0 or line["differing_from_api"] or launches.get("assign_packed cie94 exact") != bands:
        failures.append(f"cli --pipeline: {line}")

    body = src.read_bytes()
    answer: dict = {}
    create = serve.create_server

    def create_and_ask(*args, **kwargs):
        srv = create(*args, **kwargs)
        answer["processor"] = srv.service.processor

        def ask():
            try:
                t0 = time.perf_counter()
                answer["response"] = _http(srv.server_address, "POST", f"/palette?k={PIPE_K}",
                                           body)
                answer["seconds"] = time.perf_counter() - t0
            finally:
                srv.shutdown()

        threading.Thread(target=ask, daemon=True).start()
        return srv

    term = signal.getsignal(signal.SIGTERM)
    serve.create_server = create_and_ask
    try:
        rc = serve.main(["--port", "0", "--pipeline", "--batch-window-ms", "0"])
    finally:
        serve.create_server = create
        signal.signal(signal.SIGTERM, term)
    status, _, data = answer.get("response", (None, None, b""))
    proc = answer.get("processor")
    want = cli.palette_hex(ImageProcessor(device="cuda", bucketing=True, pipeline=True)
                           .palette(PIPE_K, decoded)).split(",")
    got = json.loads(data)["palette"] if status == 200 else None
    line = {"phase": "pipeline_slice", "what": "serve --pipeline: /palette?k=8 of the 4K PNG",
            "card": card, "rc": rc, "status": status, "seconds": answer.get("seconds"),
            "processor_pipeline": getattr(proc, "pipeline", None), "palette": got,
            "equal_to_direct_call": got == want}
    emit(line)
    if rc != 0 or status != 200 or not line["processor_pipeline"] or got != want:
        failures.append(f"serve --pipeline: {line}")
    return failures


def pipeline_slice(image, card: str, workdir) -> dict:
    """Pipeline mode (`ImageProcessor(pipeline=True)`, `--pipeline`): the
    checks, the entry points, then the times. Each call's launches are
    counted from 0 just before it. Returns the launches by kernel mode of
    the banded reduces and the CLI call."""
    t0 = time.perf_counter()
    counts: dict = {}
    failures = pipeline_checks(image, card, counts)
    failures += pipeline_entry_points(image, card, workdir, counts)
    pipeline_times(image, card)
    pipeline_timeline(image, card)
    emit({"phase": "pipeline_slice", "seconds": time.perf_counter() - t0, "launches": counts})
    if failures:
        raise AssertionError("pipeline_slice: " + "; ".join(failures))
    return counts


TIE_RED, TIE_BLUE = (200, 30, 40), (10, 120, 220)
TIE_SIX = ((200, 30, 40), (10, 120, 220), (250, 250, 250), (30, 30, 30), (90, 200, 60),
           (240, 200, 20))
TIE_CASES = (("2x2 two colours", 2, 2, 8), ("48x32 six flat regions", 32, 48, 16))


def tie_image(h: int, w: int) -> np.ndarray:
    """The C.7 images: a 2x2 of red over blue, or six flat regions."""
    img = np.full((h, w, 4), 255, np.uint8)
    if (h, w) == (2, 2):
        img[0, :, :3], img[1, :, :3] = TIE_RED, TIE_BLUE
        return img
    for i, col in enumerate(TIE_SIX):
        r, c = divmod(i, 3)
        img[r * h // 2:(r + 1) * h // 2, c * w // 3:(c + 1) * w // 3, :3] = col
    return img


def _kernel_launches(call) -> tuple:
    """`(kernel launches, copies)` of one `call()` as torch.profiler records
    them on the card, or "not measured" twice where it records nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not names:
        return "not measured", "not measured"
    copies = sum(1 for n in names if n.startswith(("Memcpy", "Memset")))
    return len(names) - copies, copies


def seed_ties(image, card: str) -> None:
    """ROADMAP C.7 on the card: the tie images seed, train and recolour as
    on the CPU (whose seeds the JAX package's, `tests/test_torch_seed_ties.py`),
    and the launches of the main path's seeding with and without the
    compiled-form seed side (`models/kmeans.py::seed_lab`)."""
    import torch

    from kmeans_tpu_torch import Algorithm, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.resize import resize_uint8, shrunk_dimensions

    t0 = time.perf_counter()
    failures = []
    for delta_e in ("94", "2000"):
        on_card = ImageProcessor(device="cuda", delta_e=delta_e)
        on_cpu = ImageProcessor(device="cpu", delta_e=delta_e)
        for name, h, w, k in TIE_CASES:
            img = tie_image(h, w)
            pal_card, pal_cpu = on_card.palette(k, img), on_cpu.palette(k, img)
            apart = {"palette_rows": int((pal_card != pal_cpu).any(1).sum())}
            for mode in (ReduceMode.REPLACE, ReduceMode.DITHER, ReduceMode.MELD):
                a = on_card.reduce(k, img, Algorithm.KMEANS, mode).pixels
                b = on_cpu.reduce(k, img, Algorithm.KMEANS, mode).pixels
                apart[mode.value] = int((a != b).any(-1).sum())
            rows = [tuple(int(v) for v in r[:3]) for r in pal_card]
            line = {"phase": "seed_ties", "image": name, "k": k, "delta_e": delta_e,
                    "card": card, "card_vs_cpu_apart": apart,
                    "palette_colours": {str(c): rows.count(c) for c in sorted(set(rows))}}
            emit(line)
            if any(apart.values()):
                failures.append(f"{name} delta_e={delta_e}: {apart}")
            if (h, w) == (2, 2) and delta_e == "94" and (
                    rows.count(TIE_RED), rows.count(TIE_BLUE)) != (6, 2):
                failures.append(f"2x2 palette {rows}: the JAX package has 6 red, 2 blue")
    dev = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to("cuda")
    sw, sh = shrunk_dimensions(WIDTH, HEIGHT, 256)
    rgb = resize_uint8(dev, sh, sw).reshape(-1, 3)
    work, first = srgb8_to_lab(rgb), km.reference_seed_index(sw, sh)
    calls = {
        "with_seed_side": lambda: km.plusplus_init(work, K, first, seed=km.seed_lab(rgb)),
        "stored_lab_only": lambda: km.plusplus_init(work, K, first),
    }
    line = {"phase": "seed_ties", "what": f"plusplus_init of the 4K training shrink "
                                          f"({sw}x{sh}) at k={K}", "card": card}
    for key, call in calls.items():
        call()
        launches, copies = _kernel_launches(call)
        line[f"kernel_launches_{key}"], line[f"copies_{key}"] = launches, copies
        line[f"ms_{key}"] = statistics.median(_events_ms(call) for _ in range(9))
    same = torch.equal(calls["with_seed_side"](), calls["stored_lab_only"]())
    line["same_seeds"] = same
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if failures:
        raise AssertionError("seed_ties: " + "; ".join(failures))


EXAMPLE_H, EXAMPLE_W = 192, 256  # within the 256-px training cap


def examples_slice(card: str, workdir) -> dict:
    """Each example of `kmeans_tpu_torch/examples/` once on the card, on a
    PNG written from a seeded image, its launches counted from 0 just
    before it. Returns the launches by kernel mode, summed."""
    import torch

    from kmeans_tpu_torch import Image, ImageProcessor
    from kmeans_tpu_torch.examples import batched, gif, serving, sharded
    from kmeans_tpu_torch.parallel import make_mesh
    from kmeans_tpu_torch.utils.imageio import load_gif, load_image, save_image

    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    png = workdir / "example.png"
    pixels = synthetic_image(EXAMPLE_H, EXAMPLE_W, SEED + 16)
    save_image(Image((EXAMPLE_W, EXAMPLE_H), pixels), png)
    counts: dict = {}
    failures = []

    def run(call):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for key, n in mode_counts().items():
            counts[key] = counts.get(key, 0) + n
        return out, seconds, mode_counts()

    for name, module in (("gif", gif), ("batched", batched)):
        out = workdir / f"{name}.gif"
        rc, seconds, launched = run(lambda: module.main([str(png), str(out)]))
        frames = load_gif(out) if rc == 0 else []
        colours = [len(np.unique(f.pixels.reshape(-1, 4), axis=0)) for f in frames]
        ok = rc == 0 and len(frames) == 14 and all(c <= k for c, k in zip(colours, range(2, 16)))
        emit({"phase": "examples_slice", "example": name, "card": card, "rc": rc,
              "seconds": seconds, "frames": len(frames), "colours_per_frame": colours,
              "launches": launched, "ok": ok})
        if not ok:
            failures.append(f"{name}: rc {rc}, {len(frames)} frames, colours {colours}")

    proc = ImageProcessor(device="cuda", bucketing=True)
    res, seconds, launched = run(lambda: serving.run(proc))
    apart = {
        "reduce": sum(int((o.pixels != proc.reduce(serving.K, im).pixels).any(-1).sum())
                      for o, im in zip(res["reduce"], res["requests"])),
        "reduce_many": sum(int((o.pixels != proc.reduce(serving.K, im).pixels).any(-1).sum())
                           for o, im in zip(res["reduce_many"], res["frames"])),
        "palette_many": sum(int((p != proc.palette(serving.K, im)).any(1).sum())
                            for p, im in zip(res["palette_many"], res["frames"])),
    }
    emit({"phase": "examples_slice", "example": "serving", "card": card, "seconds": seconds,
          "requests": len(res["reduce"]), "apart_from_direct_calls": apart,
          "launches": launched, "ok": not any(apart.values())})
    if any(apart.values()):
        failures.append(f"serving: apart from the direct calls {apart}")

    image = load_image(png)
    for shards in (1, 4):
        out = workdir / f"sharded{shards}.png"
        rc, seconds, launched = run(lambda: sharded.main(
            [str(png), str(K), str(out), "--shards", str(shards)]))
        got = load_image(out).pixels if rc == 0 else None
        line = {"phase": "examples_slice", "example": f"sharded --shards {shards}",
                "card": card, "rc": rc, "seconds": seconds, "launches": launched,
                "colours": None if got is None else len(np.unique(got.reshape(-1, 4), axis=0))}
        ok = rc == 0 and line["colours"] <= K
        if shards == 1 and ok:
            mesh = make_mesh([torch.device("cuda", 0)])
            want = ImageProcessor(device="cuda").reduce_sharded(K, image, mesh=mesh).pixels
            line["pixels_apart_from_reduce_sharded"] = int((got != want).any(-1).sum())
            line["pixels_apart_from_reduce"] = int(
                (got != ImageProcessor(device="cuda").reduce(K, image).pixels).any(-1).sum())
            ok = line["pixels_apart_from_reduce_sharded"] == 0
        line["ok"] = ok
        emit(line)
        if not ok:
            failures.append(f"sharded --shards {shards}: {line}")
    emit({"phase": "examples_slice", "seconds": time.perf_counter() - t_phase,
          "launches": counts})
    if failures:
        raise AssertionError("examples_slice: " + "; ".join(failures))
    return counts


SOAK_SEED, SOAK_TRIALS, SOAK_BUDGET_S = 16, 400, 60.0


def soak_slice(card: str) -> dict:
    """`kmeans_tpu_torch/tools/soak.py` on the card with a fixed seed and a
    60 s budget. Returns its launches by kernel mode, summed over the
    sections."""
    from kmeans_tpu_torch.tools import soak

    out = soak.run(SOAK_TRIALS, SOAK_SEED, SOAK_BUDGET_S, "cuda")
    counts: dict = {}
    for launched in out["launches"].values():
        for key, n in launched.items():
            counts[key] = counts.get(key, 0) + n
    emit({"phase": "soak_slice", "card": card, "seed": SOAK_SEED, "trials": out["trials"],
          "failures": out["failures"], "launches_by_section": out["launches"],
          "seconds": out["seconds"], "messages": out["messages"][:20]})
    if any(out["failures"].values()):
        raise AssertionError(f"soak_slice: {out['failures']}")
    return counts


def kernel_mode_key(name: str) -> str:
    """The `mode_counts` key of a kernel line's name: "assign_packed[fast
    cie2000, pruned]" -> "assign_packed cie2000 prune"."""
    wrapper, _, variant = name.partition("[")
    variant = variant.rstrip("]")
    metric = "cie2000" if "cie2000" in variant else "cie94"
    tiers = {"factorized": "factor", "algebraic": "algebraic", "pruned": "prune",
             "chunked": "exact-chunked"}
    tier = next((t for word, t in tiers.items() if word in variant), "exact")
    return f"{wrapper} {metric} {tier}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode, runtime
    from kmeans_tpu_torch.api import _lab_palette_to_u8, _unpack_gather
    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops import _build, kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.tools import _exp, sass

    script_t0 = time.perf_counter()
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
    emit({"phase": "runtime_probe", **runtime_probe()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        main_lib = pool.submit(_build.build)
        exp_lib = pool.submit(_exp.build_exp_library)
        runtime_lib = pool.submit(runtime.build)
        codec_lib = (pool.submit(runtime.build, "imagio_codec") if runtime.codec_available()
                     else None)
        reports = {src: pool.submit(sass.ptxas_report, _build.CSRC / src)
                   for src in ("quantize_assign.cu", "quantize_meld.cu", "lloyd_accumulate.cu")}
        scans = [pool.submit(sass.kernel_report, source, LOOP_OPCODES)
                 for source in (_build.CSRC / "dither_threshold.cu",
                                _build.EXP_CSRC / "exp_mxu.cu",
                                _build.EXP_CSRC / "exp_gather.cu")]
        lib_path, exp_path, runtime_path = (main_lib.result(), exp_lib.result(),
                                            runtime_lib.result())
        ptxas = {src: report.result() for src, report in reports.items()}
        scans = [row for scan in scans for row in scan.result()]
    _build.load_library()
    _exp.load_exp_library()
    runtime.load()
    if codec_lib is not None:
        runtime.load_codec()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "library": lib_path.name, "exp_library": exp_path.name, "runtime": runtime_path.name,
        "runtime_codec": (codec_lib.result().name if codec_lib is not None else
                          "not built: no png.h / jpeglib.h on this host (runtime_probe)"),
    })
    compiler_report(lib_path, ptxas)
    scan_report(scans)
    srgb_step_check(device)

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
    meld_tile_checks(device)
    fast_screen_checks(device)

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

    # 4h. This slice: `bucketing=True` through find, reduce (shrunk and full
    # resolution, on the weighted accumulator), the coalescers and warmup.
    bucket_counts = bucketing_slice(device, card)

    # 4i. This slice: the host palette algorithms through the entry points,
    # and the command line from file to file (then `validate_kernels`).
    algo_counts = palette_algos(image, card)
    cli_counts = cli_slice(image, card, Path("build") / "cli_slice")

    # 4j. This slice: streaming in row bands at 12288x12288, the band words
    # against the twins, the card against the CPU, and reduce_pipelined.
    stream_counts = streaming_slice(image, card)

    # 4k. This slice: the native host runtime under the main path (its strip
    # and unpacks against the numpy twins), the codec, and the HTTP service.
    native_counts: dict = {}
    native_failures = native_vs_twins(image, card, native_counts)
    if native_failures:
        raise AssertionError("native_vs_twins: " + "; ".join(native_failures))
    codec_counts, gif = codec_slice(image, card, Path("build") / "codec_slice")
    serve_counts = serving_slice(card, gif)

    # 4l. This slice: the sharded entry points on meshes of the one card.
    shard_counts = sharding_slice(image, card)

    # 4m. This slice: pipeline mode (host-shrunk training strips, the banded
    # reduce) through the API, the CLI and the server, and its times.
    pipe_counts = pipeline_slice(image, card, Path("build") / "pipeline_slice")

    # 4n. This slice: seeding at exact ties (C.7), the examples and the soak.
    seed_ties(image, card)
    example_counts = examples_slice(card, Path("build") / "examples_slice")
    soak_counts = soak_slice(card)

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
              sum(cli_counts["validate_kernels"].get(f"assign_u8 cie94 {tier}", 0)
                  for tier in ("exact", "exact-chunked")),
              colour_err["assign_u8", "cie94", False], frames_times["assign_u8"],
              launched_by="kmeans_tpu_torch.ops.validate.validate_kernels (cli_slice)"),
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
         "replaces": "kmeans_tpu/ops/quantize.py:112 (a lax.fori_loop, no Pallas kernel)",
         "latency_floor_ms": threshold["latency_floor_ms"], "updates": threshold["updates"]},
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
        # The constant placement's entries carry its fill's time (a copy of
        # its own, made only when the table changed), the gather's the
        # launch floor (an empty kernel) and a resident call's device ops.
        *[{**exp_entry(f"exp_gather[{p}]", "exp_gather.cu", "tools/exp_gather.py:52",
                       gather["counts"][f"exp_gather {p} table"], 0, gather["timing"]["gather", p],
                       "kmeans_tpu_torch.tools.exp_gather"),
           "library_ms": gather["take_ms"], "launch_floor_ms": gather["empty_ms"],
           **({"fill_ms": gather["fill_ms"], "fills": gather["counts"][
               "exp_lut_fill constant copy"], "resident_device_ops": gather["resident_ops"]}
              if p == "constant" else {})} for p in ("shared", "constant", "global")],
        *[{**exp_entry(f"exp_lut[{p}]", "exp_gather.cu", "tools/exp_gather.py:152",
                       gather["counts"][f"exp_lut {p} table"], 0, gather["timing"]["lut", p],
                       "kmeans_tpu_torch.tools.exp_gather"),
           "copy_ms": gather["copy_ms"],
           **({"fill_ms": gather["fill_ms"]} if p == "constant" else {})}
          for p in ("shared", "constant", "global")],
        exp_entry("exp_pow", "exp_gather.cu", "tools/exp_gather.py:160",
                  gather["counts"]["exp_pow - curve"], gather["pow_err"], gather["timing"]["pow"],
                  "kmeans_tpu_torch.tools.exp_gather"),
        # The tool's probe of the pow kernel's curve on its 256 inputs: no
        # TPU kernel of its own; err in ulps against powf's term.
        exp_entry("exp_pow_probe", "exp_gather.cu", "tools/exp_gather.py:160 (a probe of "
                  "pow_kernel's curve, no kernel)", gather["counts"]["exp_pow_probe - curve"],
                  gather["probe_ulps"], gather["timing"]["pow_probe"],
                  "kmeans_tpu_torch.tools.exp_gather"),
        # The tool's helper for powf's ulps against the table: no TPU kernel
        # (the reference makes the table with numpy); err in ulps.
        exp_entry("exp_pow_table", "exp_gather.cu", "tools/exp_gather.py:47 (numpy, no kernel)",
                  gather["counts"]["exp_pow_table - powf"], gather["pow_table_ulps"],
                  gather["timing"]["pow_table"], "kmeans_tpu_torch.tools.exp_gather"),
    ]
    # The kernels of the bucketing slice: its launches (counted from 0 just
    # before each of its paths) and the entry points that made them.
    bucket_paths = {
        "assign_packed": ("assign_packed cie94 exact",
                          "bucketed reduce, find, find_batch, find_many"),
        "meld_packed": ("meld_packed cie94 exact", "bucketed reduce (meld)"),
        "lloyd_accumulate": ("lloyd_accumulate cie94 exact",
                             "bucketed reduce with train_max_size=None (weight plane)"),
        "assign_frames_packed": ("assign_frames_packed cie94 exact", "reduce_many"),
        "dither_threshold": ("dither_threshold cie94 exact", "bucketed reduce and find (dither)"),
    }
    # The kernels of this slice's two paths: their launches (each call
    # counted from 0 just before it) and the entry points that made them.
    slice_paths = {
        "assign_packed": ("assign_packed cie94 exact",
                          "host-palette reduce (replace, dither)", "reduce, find"),
        "assign_packed[cie2000]": ("assign_packed cie2000 exact", None,
                                   "--delta-e 2000 reduce"),
        "meld_packed": ("meld_packed cie94 exact", "host-palette reduce (meld)", "reduce -m meld"),
        "lloyd_accumulate": ("lloyd_accumulate cie94 exact", None,
                             "--train-max-size none reduce"),
        "dither_threshold": ("dither_threshold cie94 exact", "host-palette reduce (dither)",
                             "reduce -m dither"),
    }
    for line in kernel_lines:
        if line["name"] not in slice_paths:
            continue
        key, algo_entries, cli_entries = slice_paths[line["name"]]
        if algo_entries is not None:
            if algo_counts.get(key, 0) < 1:
                raise AssertionError(f"palette_algos never launched {line['name']}")
            line["launches_palette_algos"] = algo_counts[key]
            line["launched_by"] += f"; palette_algos: {algo_entries}"
        if cli_counts.get(key, 0) < 1:
            raise AssertionError(f"cli_slice never launched {line['name']}")
        line["launches_cli_slice"] = cli_counts[key]
        line["launched_by"] += f"; cli_slice, kmeans_tpu_torch.cli.main: {cli_entries}"
    # The kernels of the streaming slice: its launches (each call counted
    # from 0 just before it) and the entry points that made them.
    stream_paths = {
        "assign_packed": ("assign_packed cie94 exact",
                          "reduce_streamed, find_streamed, reduce_pipelined (replace, dither)"),
        "meld_packed": ("meld_packed cie94 exact",
                        "reduce_streamed, find_streamed, reduce_pipelined (meld)"),
        "dither_threshold": ("dither_threshold cie94 exact",
                             "reduce_streamed, find_streamed (once a call), reduce_pipelined"),
        "quantize_rgba": ("quantize_rgba cie94 exact", "find_streamed past 1024 colours"),
        "lloyd_accumulate": ("lloyd_accumulate cie94 exact",
                             "reduce_streamed with train_max_size=2048 (weight plane)"),
    }
    for line in kernel_lines:
        if line["name"] in stream_paths:
            key, entries = stream_paths[line["name"]]
            if stream_counts.get(key, 0) < 1:
                raise AssertionError(f"the streaming slice never launched {line['name']}")
            line["launches_streaming_slice"] = stream_counts[key]
            line["launched_by"] += f"; streaming_slice: {entries}"
    for line in kernel_lines:
        line["design"] = design_of(line["name"])
        if line["name"] in bucket_paths:
            key, entries = bucket_paths[line["name"]]
            if bucket_counts.get(key, 0) < 1:
                raise AssertionError(f"the bucketing slice never launched {line['name']}")
            line["launches_bucketing_slice"] = bucket_counts[key]
            line["launched_by"] += f"; ImageProcessor(bucketing=True): {entries}"
    # The kernels of the runtime and service slice: their launches and the
    # entry points that made them.
    service_paths = {
        "assign_packed": ("assign_packed cie94 exact",
                          "native_vs_twins (reduce_streamed), serve /find, /reduce (window 0)"),
        "meld_packed": ("meld_packed cie94 exact", "native_vs_twins (reduce_streamed meld)"),
        "assign_frames_packed": ("assign_frames_packed cie94 exact",
                                 "cli reduce-gif / find-gif, serve /reduce-gif, /find-gif, "
                                 "reduce_many / find_many behind /reduce, /find"),
        "dither_threshold": ("dither_threshold cie94 exact",
                             "cli find-gif -m dither, serve /reduce?mode=dither, /find-gif"),
    }
    for line in kernel_lines:
        if line["name"] in service_paths:
            key, entries = service_paths[line["name"]]
            launched = {"native_vs_twins": native_counts.get(key, 0),
                        "codec_slice": codec_counts.get(key, 0),
                        "serving_slice": serve_counts.get(key, 0)}
            if not any(launched.values()):
                raise AssertionError(f"the runtime and service slice never launched "
                                     f"{line['name']}")
            for name, n in launched.items():
                line[f"launches_{name}"] = n
            line["launched_by"] += f"; runtime and service slice: {entries}"
    # The kernels of the sharding slice: their launches (each call counted
    # from 0 just before it) and the entry points that made them.
    shard_paths = {
        "assign_packed": ("assign_packed cie94 exact",
                          "find_sharded, reduce_sharded, reduce_images_sharded, "
                          "find_batch_sharded (replace, dither; 1 a shard)"),
        "assign_packed[cie2000]": ("assign_packed cie2000 exact",
                                   "reduce_sharded delta_e=2000 (1 a shard)"),
        "meld_packed": ("meld_packed cie94 exact",
                        "find_sharded, reduce_sharded, find_batch_sharded (meld; 1 a shard)"),
        "quantize_rgba": ("quantize_rgba cie94 exact", "find_sharded past 1024 colours "
                                                       "(1 a shard)"),
        "lloyd_accumulate": ("lloyd_accumulate cie94 exact",
                             "reduce_sharded, palette_sharded with train_max_size=None "
                             "(1 a shard an iteration)"),
        "dither_threshold": ("dither_threshold cie94 exact",
                             "find_sharded, reduce_sharded, find_batch_sharded "
                             "(dither, once a call)"),
    }
    for line in kernel_lines:
        if line["name"] in shard_paths:
            key, entries = shard_paths[line["name"]]
            if shard_counts.get(key, 0) < 1:
                raise AssertionError(f"the sharding slice never launched {line['name']}")
            line["launches_sharding_slice"] = shard_counts[key]
            line["launched_by"] += f"; sharding_slice: {entries}"
    # The kernels of the pipeline slice: their launches (each call counted
    # from 0 just before it) and the entry points that made them.
    pipe_paths = {
        "assign_packed": ("assign_packed cie94 exact",
                          "reduce(pipeline=True) replace and dither (1 a band: 5 at 4K), "
                          "cli --pipeline reduce"),
        "dither_threshold": ("dither_threshold cie94 exact",
                             "reduce(pipeline=True) dither (once a call)"),
    }
    for line in kernel_lines:
        if line["name"] in pipe_paths:
            key, entries = pipe_paths[line["name"]]
            if pipe_counts.get(key, 0) < 1:
                raise AssertionError(f"the pipeline slice never launched {line['name']}")
            line["launches_pipeline_slice"] = pipe_counts[key]
            line["launched_by"] += f"; pipeline_slice: {entries}"
    # The launches of the examples and the soak (each example counted from
    # 0 just before it, each soak section by its own difference), by the
    # kernel mode each line names; the threshold kernel's of both metrics.
    for line in kernel_lines:
        key = kernel_mode_key(line["name"])
        for name, counts in (("examples_slice", example_counts), ("soak_slice", soak_counts)):
            if line["name"] == "dither_threshold":
                line[f"launches_{name}"] = sum(n for m, n in counts.items()
                                               if m.startswith("dither_threshold "))
            else:
                line[f"launches_{name}"] = counts.get(key, 0)
    emit({"phase": "total", "card": card, "seconds": time.perf_counter() - script_t0})
    emit({"kernels": kernel_lines})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--warmup-probe":
        sys.exit(warmup_probe(sys.argv[2]))
    sys.exit(main())
