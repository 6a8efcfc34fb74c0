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
   `row_offset=3` and one 2160x3840 image; the words must be equal;
4. the slice: drives `ImageProcessor(device="cuda")` through `reduce`
   (replace and dither), `palette` and `find` on a seeded synthetic
   3840x2160 image, checks the outputs, checks that each reduce equals
   the plain version's indices for the trained palette, checks that the
   assign kernel was launched by those calls, and holds a small reduce on
   the card against the same reduce on the CPU;
5. times: the median of 5 warm 4K k=8 reduces with their phases, and the
   kernel alone against the plain version alone (CUDA events).

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


def profile_reduce(proc, image, card: str) -> dict:
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
        "phase": "timing", "what": "profile of one reduce 3840x2160 k=8 replace",
        "card": card, "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if measured else "not measured",
        "device_idle_share": 1 - busy_us / 1e3 / wall_ms if measured else "not measured",
        "device_events": len(device_events),
        "top_device_events": [{"name": n, "ms": t, "count": c} for n, (t, c) in top],
    }


def unique_rgba(pixels: np.ndarray) -> np.ndarray:
    return np.unique(np.ascontiguousarray(pixels).view(np.uint32))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from kmeans_tpu_torch import Image, ImageProcessor, ReduceMode
    from kmeans_tpu_torch.api import _lab_palette_to_u8, _unpack_gather
    from kmeans_tpu_torch.ops import _build, kernels
    from kmeans_tpu_torch.ops.quantize import dither_threshold
    from kmeans_tpu_torch.utils.profiling import collect_phases

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

    # 4. The slice, through the entry points a user calls.
    image = synthetic_image(HEIGHT, WIDTH)
    proc = ImageProcessor(device="cuda")
    rng = np.random.default_rng(SEED + 1)
    find_colors = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    find_colors[:, 3] = 255

    kernels.ASSIGN_PACKED_LAUNCHES = 0
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
    # One launch per reduce and per find; palette trains only.
    if counts != [1, 2, 2, 3]:
        raise AssertionError(f"assign kernel launch counts {counts}, expected [1, 2, 2, 3]")

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

    # 5. Times.
    runs = []
    for _ in range(6):
        phases: dict = {}
        t0 = time.perf_counter()
        with collect_phases(phases):
            proc.reduce(K, image, reduce_mode=ReduceMode.REPLACE)
        runs.append((time.perf_counter() - t0, phases))
    warm = runs[1:]
    e2e = statistics.median(r[0] for r in warm)
    phase_ms = {
        name: statistics.median(r[1].get(name, 0.0) for r in warm) * 1e3
        for name in ("host_prep", "upload", "device", "lloyd_sync", "readback", "unpack")
    }
    emit({
        "phase": "timing", "what": "reduce 3840x2160 k=8 replace, median of 5 warm",
        "card": card, "e2e_ms": e2e * 1e3, "mpix_per_s": HEIGHT * WIDTH / e2e / 1e6,
        "e2e_ms_each": [r[0] * 1e3 for r in warm], "phases_ms": phase_ms,
        "iterations": proc.last_iterations,
        "lloyd_checks": (proc.last_iterations - 1) // 8,
    })

    emit(profile_reduce(proc, image, card))

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

    emit({"kernels": [{
        "name": "assign_packed",
        "route": "cuda",
        "source": "kmeans_tpu_torch/csrc/quantize_assign.cu",
        "replaces": "kmeans_tpu/ops/kernels.py:669",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": timings["replace"][0],
        "plain_ms": timings["replace"][1],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
