"""Time the port's kernels of one or more checkouts on a card, in turns.

    python3 kmeans_tpu_torch/tools/kernel_times.py [--fast] [CHECKOUT ...]

builds the kernels of each CHECKOUT (default: this file's checkout) from
its `kmeans_tpu_torch/csrc/` into this checkout's `build/`, and times them
through this checkout's wrappers (the kernels' C interface is the same in
every tree that has these modes), in the order given: to compare two
trees on one card, unpack the other one (`git archive`) into an ignored
directory and pass both in turns, `PARENT . . PARENT`. Each turn prints
one JSON line: the checkout, the card's name and power limit, and the
mean milliseconds of each kernel mode by CUDA events, each launch after
a 256 MB write that evicts the L2 cache, on a seeded random 3840x2160
image and seeded random palettes:

- the exact CIE94 `assign_packed` (k = 8, 64) and CIEDE2000 (k = 8), the
  colour-out `quantize_rgba` (k = 2048);
- `meld_packed` under CIE94 (k = 8, 16, 32, 1025) and CIEDE2000 (k = 8,
  16, 32: the `d(closest, second)` table's cutoff lies between), the
  chunked meld on a 1920x1080 image at k = 16384, and
  `meld_frames_packed` on 16 frames of 1920x1080 at k = 8;
- `lloyd_accumulate` under CIE94 (k = 8, 64, 256, 512) and CIEDE2000
  (k = 8);
- with `--fast`, at k = 64 and 256: the factorized CIE94 and pruned
  CIEDE2000 tiers of `assign_packed`, `meld_packed` and
  `lloyd_accumulate`, the algebraic CIE94 accumulator, and at k = 64 the
  fast tiers of `assign_frames_packed` and `meld_frames_packed` on the 16
  frames; then the fast tiers again on `chip_smoke.py`'s 4K
  gradient-plus-noise image with palettes `ImageProcessor` trains on it
  (`_trained_` in the name), whose pixels cluster about the palette as
  a user's do and which time the pruned tier's data-dependent work
  otherwise than random palettes.

A last line, `{"same_outputs": {mode: bool}}`, says for each mode whether
every checkout's output equals the first one's bit for bit.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# The C entry points a turn calls, declared as this checkout declares them.
ENTRY_POINTS = ("kmeans_assign", "kmeans_meld", "kmeans_lloyd_grid_blocks",
                "kmeans_lloyd_accumulate", "kmeans_dither_threshold", "kmeans_error_string")


class _Declared:
    """Takes the argument and result types `_build` declares for the main
    library, to give them to each checkout's library (an older tree may
    lack an entry point the main library has)."""

    def __getattr__(self, name):
        entry = type(name, (), {})()
        setattr(self, name, entry)
        return entry


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="*", default=[str(ROOT)])
    parser.add_argument("--fast", action="store_true", help="also time the fast tiers")
    args = parser.parse_args()

    import torch

    from kmeans_tpu_torch.ops import _build, kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    roots = [Path(c).resolve() for c in args.checkouts]
    trees = sorted(set(roots))

    def build(root):
        tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
        return _build.build(root / "kmeans_tpu_torch" / "csrc", f"kernel_times_{tag}")

    with ThreadPoolExecutor(4) as pool:
        paths = dict(zip(trees, pool.map(build, trees)))
    declared = _Declared()
    _build._declare_main(declared)
    libs = {}
    for root, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for name in ENTRY_POINTS:
            getattr(lib, name).argtypes = getattr(declared, name).argtypes
            getattr(lib, name).restype = getattr(declared, name).restype
        libs[root] = lib

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def rgb_image(h, w):
        return torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)

    def palette(k):
        colors = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(dev)
        return srgb8_to_lab(colors).contiguous()

    rgb = rgb_image(2160, 3840)
    hd = rgb_image(1080, 1920)
    frames = torch.stack([rgb_image(1080, 1920) for _ in range(16)])
    planes, n_valid = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    # (mode, call, launches timed): every palette drawn once, before the turns.
    calls = []

    def add(mode, fn, reps):
        calls.append((mode, fn, reps))

    for k in (8, 64):
        cents = palette(k)
        add(f"assign_k{k}", lambda c=cents: kernels.assign_packed(rgb, c, 0.0), 20)
    cents = palette(8)
    add("assign_cie2000_k8",
        lambda c=cents: kernels.assign_packed(rgb, c, 0.0, metric="cie2000"), 10)
    cents = palette(2048)
    add("rgba_k2048", lambda c=cents: kernels.quantize_rgba(rgb, c, 0.0), 3)
    for k in (8, 16, 32, 1025):
        cents = palette(k)
        add(f"meld_k{k}", lambda c=cents: kernels.meld_packed(rgb, c), 3 if k > 32 else 10)
    for k in (8, 16, 32):
        cents = palette(k)
        add(f"meld_cie2000_k{k}",
            lambda c=cents: kernels.meld_packed(rgb, c, metric="cie2000"), 5)
    cents = palette(16384)
    add("meld_1080p_k16384", lambda c=cents: kernels.meld_packed(hd, c), 3)
    cents = torch.stack([palette(8) for _ in range(16)])
    add("meld_frames_k8", lambda c=cents: kernels.meld_frames_packed(frames, c), 10)
    for k in (8, 64, 256, 512):
        cents = palette(k)
        add(f"lloyd_k{k}", lambda c=cents: kernels.lloyd_accumulate(planes, c, n_valid), 10)
    cents = palette(8)
    add("lloyd_cie2000_k8",
        lambda c=cents: kernels.lloyd_accumulate(planes, c, n_valid, metric="cie2000"), 10)
    if args.fast:
        for k in (64, 256):
            cents = palette(k)
            for metric in ("cie94", "cie2000"):
                add(f"assign_fast_{metric}_k{k}", lambda c=cents, m=metric: kernels.assign_packed(
                    rgb, c, 0.0, metric=m, fast=True), 5)
                add(f"meld_fast_{metric}_k{k}", lambda c=cents, m=metric: kernels.meld_packed(
                    rgb, c, metric=m, fast=True), 5)
                add(f"lloyd_fast_{metric}_k{k}", lambda c=cents, m=metric:
                    kernels.lloyd_accumulate(planes, c, n_valid, metric=m, fast=True), 5)
            add(f"lloyd_fast_cie94_inertia_k{k}", lambda c=cents: kernels.lloyd_accumulate(
                planes, c, n_valid, emit_inertia=True, fast=True), 5)
        # The palettes users meet: trained by `ImageProcessor` (the shrunk
        # training, no kernel) on `chip_smoke.py`'s 4K gradient-plus-noise
        # image, whose pixels the kernels then take.
        from chip_smoke import synthetic_image
        from kmeans_tpu_torch import Image, ImageProcessor

        image = synthetic_image(2160, 3840)
        grad = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(dev)
        grad_planes, grad_valid = kernels.pack_lab_planes(srgb8_to_lab(grad.reshape(-1, 3)))
        for k in (64, 256):
            for metric, delta_e in (("cie94", "94"), ("cie2000", "2000")):
                cents = ImageProcessor(device="cuda", delta_e=delta_e).extract_palette_kmeans(
                    Image((3840, 2160), image), k).contiguous()
                add(f"assign_fast_{metric}_trained_k{k}", lambda c=cents, m=metric:
                    kernels.assign_packed(grad, c, 0.0, metric=m, fast=True), 5)
                add(f"meld_fast_{metric}_trained_k{k}", lambda c=cents, m=metric:
                    kernels.meld_packed(grad, c, metric=m, fast=True), 5)
                add(f"lloyd_fast_{metric}_trained_k{k}", lambda c=cents, m=metric:
                    kernels.lloyd_accumulate(grad_planes, c, grad_valid, metric=m, fast=True), 5)
        cents = torch.stack([palette(64) for _ in range(16)])
        for metric in ("cie94", "cie2000"):
            add(f"assign_frames_fast_{metric}_k64", lambda c=cents, m=metric:
                kernels.assign_frames_packed(frames, c, 0.0, metric=m, fast=True), 3)
            add(f"meld_frames_fast_{metric}_k64", lambda c=cents, m=metric:
                kernels.meld_frames_packed(frames, c, metric=m, fast=True), 3)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    digests = {}
    for root in roots:
        _build._libs[_build.MAIN_NAME] = libs[root]
        out = {"checkout": str(root), "card": card}
        for mode, fn, reps in calls:
            words = fn()
            torch.cuda.synchronize()
            digest = hashlib.sha256(words.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            digests.setdefault(mode, set()).add(digest)
            out[f"{mode}_ms"] = ms(fn, reps)
        print(json.dumps(out), flush=True)
    del _build._libs[_build.MAIN_NAME]
    print(json.dumps({"same_outputs": {mode: len(d) == 1 for mode, d in digests.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
