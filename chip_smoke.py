#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and the CUDA toolkit (`nvcc`); it builds the port's kernels
from `kmeans_tpu_torch/csrc/` and then:

1. device: prints the card (`nvidia-smi` name and power limit), torch and
   CUDA versions;
2. build: compiles the kernels and prints the seconds it took;
3. kernel vs plain: holds `assign_packed` (the CUDA kernel) against
   `assign_packed_reference` (plain PyTorch) on the same CUDA tensors,
   over palette sizes, both modes, ragged shapes, `k_active < kp`,
   `row_offset=3` and one 2160x3840 image; the words must be equal.
   Then holds `lloyd_accumulate` (the CUDA kernel) against
   `lloyd_accumulate_reference` over k = 1..512, ragged pixel counts,
   `k_active < kp`, a weight plane, the inertia column, bfloat16 planes
   and one 3840x2160 image: counts equal, the other columns within
   `1e-5 * (|plain| + 128 * count)`, and two launches give equal totals;
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
   reduce of a 1200x1000 image on the card against the CPU;
5. times: the median of 5 warm 4K k=8 reduces with their phases, for the
   shrunk and the full-resolution training in turns, and each kernel
   alone against its plain version alone (CUDA events), beside its
   bound.

Every phase prints one JSON line. The script exits non-zero on any
failure, and when no CUDA device is present. Its last three lines are the
kernels' summary, the card's `nvidia-smi` line, and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
HEIGHT, WIDTH = 2160, 3840
K = 8
COMPARE_KS = (1, 2, 4, 8, 16, 17, 256, 257, 512, 1024)
RAGGED = ((61, 97), (257, 129), (8, 8))
ACCUM_KS = (1, 2, 8, 17, 64, 65, 256, 512)
ACCUM_PIXELS = 100_003  # ragged: not a multiple of the 16384-pixel granule
# Published peaks of one H100 SXM at 700 W (the rates a bound is taken at).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def compare_case(h, w, k, mode, device, k_active=None, row_offset=0, seed=1):
    """Kernel vs plain on one case: (mismatched words, max |index diff|)."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.utils.packing import pack_bits, unpack_tile_words

    rng = np.random.default_rng(seed + 7919 * k + h)
    rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(device)
    cents = random_palette_lab(k, seed + k, device)
    thr = dither_threshold(cents, k_active) if mode == "dither" else 0.0
    got = kernels.assign_packed(rgb, cents, thr, k_active, mode, row_offset)
    want = kernels.assign_packed_reference(rgb, cents, thr, k_active, mode, row_offset)
    torch.cuda.synchronize()
    mismatched = int((got != want).sum().item())
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    gi = unpack_tile_words(got.cpu().numpy(), h, w, bits, rows).astype(np.int64)
    wi = unpack_tile_words(want.cpu().numpy(), h, w, bits, rows).astype(np.int64)
    return mismatched, int(np.abs(gi - wi).max())


def random_lab(n: int, seed: int, device):
    """`[n, 3]` Lab of seeded random sRGB pixels."""
    import torch

    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    rng = np.random.default_rng(seed)
    return srgb8_to_lab(torch.from_numpy(rng.integers(0, 256, (n, 3), dtype=np.uint8)).to(device))


def accum_case(lab, k, device, k_active=None, weighted=False, inertia=False,
               bf16=False, seed=3):
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
    args = (planes, cents, n, k_active, w)
    got = kernels.lloyd_accumulate(*args, emit_inertia=inertia)
    again = kernels.lloyd_accumulate(*args, emit_inertia=inertia)
    want = kernels.lloyd_accumulate_reference(*args, emit_inertia=inertia)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    scale = want.double().abs() + 128.0 * want[:, 3:4].double()
    # 0 / 0 (an empty cluster) is no error; any error where the scale is 0 fails.
    ratio = torch.where(scale > 0, err / scale.clamp(min=1e-300), err * float("inf"))
    return {
        "phase": "lloyd_kernel_vs_plain", "pixels": n, "k": k, "k_active": k_active,
        "weighted": weighted, "emit_inertia": inertia, "bf16": bf16,
        "counts_equal": bool(torch.equal(got[:, 3], want[:, 3])),
        "max_abs_err": float(err.max()),
        "max_err_over_scale": float(torch.nan_to_num(ratio, nan=0.0).max()),
        "deterministic": bool(torch.equal(got, again)),
        "total_count": float(want[:, 3].sum()),
    }


def accum_bound(n_pix, n_valid, kp, k_active, stats, bf16=False, weighted=False):
    """The least time (ms) the card could take for one accumulator call,
    and what bounds it. Bytes: the planes (and weights) read once, the
    centroids read and the totals written once. Float32 operations, as
    `csrc/lloyd_accumulate.cu` spells them, for each valid pixel: 9
    pixel-side, 18 per active centroid, 2 per output column."""
    bytes_moved = n_pix * (3 * (2 if bf16 else 4) + (4 if weighted else 0)) + kp * 12 + kp * stats * 4
    ops = n_valid * (9 + 18 * k_active + 2 * stats)
    return _bound(bytes_moved, ops)


def assign_bound(n, n_pad, n_words, kp, k_active):
    """The least time (ms) the card could take for one replace-mode
    assign call, and what bounds it. Bytes: the RGB image read once, the
    words written once, the gamma table and centroids read once. Float32
    operations, as `csrc/quantize_assign.cu` spells them, for each of the
    `n_pad` pixels it computes: 18 for RGB -> XYZ, 9 for the three Lab
    f-functions (each `powf` counted as one), 6 for L, a, b, 9 pixel-side
    CIE94 terms and 18 per active centroid."""
    bytes_moved = 3 * n + 4 * n_words + 256 * 4 + kp * 12
    ops = n_pad * (42 + 18 * k_active)
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


def profile_reduce(proc, image, card: str, what: str = "reduce 3840x2160 k=8 replace") -> dict:
    """One warm 4K reduce under torch.profiler: the device's busy time (the
    union of the intervals of every event on the card: kernels and copies),
    its share of the wall time, and the costliest device events by name.
    The profiler's own host overhead lengthens the wall time, so the idle
    share it gives is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmeans_tpu_torch import ReduceMode

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.reduce(K, image, reduce_mode=ReduceMode.REPLACE)
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


def timed_reduces(procs: dict, image, card: str) -> list:
    """For each `what -> processor`, the median of 5 warm
    `reduce(K, image)` calls (after one more) with their phases. The
    processors take turns, so a drift of the host's clock or state falls
    on all of them alike. Returns one JSON line for each."""
    from kmeans_tpu_torch import ReduceMode
    from kmeans_tpu_torch.utils.profiling import collect_phases

    runs = {what: [] for what in procs}
    for _ in range(6):
        for what, proc in procs.items():
            phases: dict = {}
            t0 = time.perf_counter()
            with collect_phases(phases):
                proc.reduce(K, image, reduce_mode=ReduceMode.REPLACE)
            runs[what].append((time.perf_counter() - t0, phases))
    lines = []
    for what, proc in procs.items():
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

    device = torch.device("cuda", 0)
    card = card_line()

    # 1. Device.
    emit({
        "phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "count": torch.cuda.device_count(),
    })

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "compile_seconds": _build.last_build_seconds, "library": lib_path.name,
    })

    # 3. Kernel vs plain on the card: the words must be equal.
    failures = []
    max_abs_err = 0
    cases = [(h, w, k, m, None, 0) for k in COMPARE_KS for (h, w) in RAGGED
             for m in ("replace", "dither")]
    cases += [
        (61, 97, 16, "dither", 11, 0),     # k_active < kp
        (61, 97, 257, "replace", 200, 0),  # k_active < kp, 16-bit tier
        (61, 97, 8, "dither", None, 3),    # row_offset
        (HEIGHT, WIDTH, K, "replace", None, 0),
        (HEIGHT, WIDTH, K, "dither", None, 0),
    ]
    for h, w, k, mode, k_active, row_offset in cases:
        mism, err = compare_case(h, w, k, mode, device, k_active, row_offset)
        max_abs_err = max(max_abs_err, err)
        emit({
            "phase": "kernel_vs_plain", "h": h, "w": w, "k": k, "mode": mode,
            "k_active": k_active, "row_offset": row_offset,
            "mismatched_words": mism, "max_abs_index_diff": err,
        })
        if mism:
            failures.append(f"kernel_vs_plain {h}x{w} k={k} {mode}: {mism} words differ")
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
    accum_err = 0.0
    for lab, k, opts in accum_cases:
        line = accum_case(lab, k, device, **opts)
        emit(line)
        accum_err = max(accum_err, line["max_abs_err"])
        if not (line["counts_equal"] and line["deterministic"]
                and line["max_err_over_scale"] <= 1e-5):
            failures.append(f"lloyd_kernel_vs_plain k={k} {opts}: {line}")
    if failures:
        raise AssertionError("; ".join(failures))

    # 4. The slice, through the entry points a user calls.
    proc = ImageProcessor(device="cuda")
    rng = np.random.default_rng(SEED + 1)
    find_colors = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    find_colors[:, 3] = 255

    kernels.ASSIGN_PACKED_LAUNCHES = 0
    kernels.LLOYD_ACCUMULATE_LAUNCHES = 0
    counts = []
    out_replace = proc.reduce(K, image, reduce_mode=ReduceMode.REPLACE)
    iters_replace = proc.last_iterations
    counts.append(kernels.ASSIGN_PACKED_LAUNCHES)
    out_dither = proc.reduce(K, image, reduce_mode=ReduceMode.DITHER)
    counts.append(kernels.ASSIGN_PACKED_LAUNCHES)
    pal = proc.palette(K, image)
    counts.append(kernels.ASSIGN_PACKED_LAUNCHES)
    out_find = proc.find(image, find_colors, ReduceMode.DITHER)
    counts.append(kernels.ASSIGN_PACKED_LAUNCHES)
    torch.cuda.synchronize()
    launches = kernels.ASSIGN_PACKED_LAUNCHES
    # One launch per reduce and per find; palette trains only, and the
    # 256x144 shrink trains on the one-hot trainer.
    if counts != [1, 2, 2, 3]:
        raise AssertionError(f"assign kernel launch counts {counts}, expected [1, 2, 2, 3]")
    if kernels.LLOYD_ACCUMULATE_LAUNCHES != 0:
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
        "assign_launches": launches,
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
    kernels.ASSIGN_PACKED_LAUNCHES = 0
    kernels.LLOYD_ACCUMULATE_LAUNCHES = 0
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
    full_launches = kernels.LLOYD_ACCUMULATE_LAUNCHES
    full_assign = kernels.ASSIGN_PACKED_LAUNCHES
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

    # 5. Times: the shrunk and the full-resolution reduce in turns.
    shrunk_timing, full_timing = timed_reduces({
        "reduce 3840x2160 k=8 replace, median of 5 warm": proc,
        "full-resolution reduce 3840x2160 k=8 replace, median of 5 warm": full,
    }, image, card)
    full_timing["accumulator_launches_per_reduce"] = full.last_iterations
    emit(shrunk_timing)
    emit(full_timing)
    emit(profile_reduce(proc, image, card))
    emit(profile_reduce(full, image, card, "full-resolution reduce 3840x2160 k=8 replace"))

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

    emit({"kernels": [{
        "name": "assign_packed",
        "route": "cuda",
        "source": "kmeans_tpu_torch/csrc/quantize_assign.cu",
        "replaces": "kmeans_tpu/ops/kernels.py:669",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": timings["replace"][0],
        "plain_ms": timings["replace"][1],
        "bound_ms": assign_bound_ms,
        "bound_by": assign_bound_by,
        "library_ms": None,
    }, {
        "name": "lloyd_accumulate",
        "route": "cuda",
        "source": "kmeans_tpu_torch/csrc/lloyd_accumulate.cu",
        "replaces": "kmeans_tpu/ops/kernels.py:1270",
        "launches": full_launches,
        "max_abs_err": accum_err,
        "ms": accum_ms[False][0],
        "plain_ms": accum_ms[False][1],
        "bound_ms": accum_ms[False][2],
        "bound_by": accum_ms[False][3],
        "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
