"""Time the assign and accumulator kernels of one checkout on a card.

    python3 kmeans_tpu_torch/tools/kernel_times.py [--fast] [CHECKOUT]

imports `kmeans_tpu_torch` from CHECKOUT (default: this file's checkout),
builds its kernels into CHECKOUT/build, and prints one JSON line: the
card's name and power limit, and the mean milliseconds of the exact CIE94
`assign_packed` (k = 8, 64), `meld_packed` (k = 8, 1025) and
`lloyd_accumulate` (k = 8, 64, 256, 512), the exact CIEDE2000
`assign_packed` and `lloyd_accumulate` (k = 8) and the colour-out
`quantize_rgba` (k = 2048) on a
seeded random 3840x2160 image, by CUDA events, each launch after a
256 MB write that evicts the L2 cache. With `--fast` it also times the
fast tiers at k = 64 and 256: the factorized CIE94 and the pruned
CIEDE2000 assign and accumulator, and the algebraic CIE94 accumulator
(CHECKOUT must have them). To compare two trees on one card, unpack the
other one (`git archive`) into an ignored directory and run both in one
call, in turns: A, B, B, A.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkout", nargs="?", default=Path(__file__).resolve().parents[2])
    parser.add_argument("--fast", action="store_true", help="also time the fast tiers")
    args = parser.parse_args()
    root = Path(args.checkout)
    sys.path.insert(0, str(root.resolve()))

    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8)).to(dev)
    planes, n_valid = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def palette(k):
        colors = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(dev)
        return srgb8_to_lab(colors).contiguous()

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
    out = {"checkout": str(root), "card": card}
    for k in (8, 64):
        cents = palette(k)
        out[f"assign_k{k}_ms"] = ms(lambda: kernels.assign_packed(rgb, cents, 0.0), 20)
    for k in (8, 1025):
        cents = palette(k)
        out[f"meld_k{k}_ms"] = ms(lambda: kernels.meld_packed(rgb, cents), 20 if k == 8 else 3)
    for k in (8, 64, 256, 512):
        cents = palette(k)
        out[f"lloyd_k{k}_ms"] = ms(lambda: kernels.lloyd_accumulate(planes, cents, n_valid), 10)
    cents = palette(8)
    out["assign_cie2000_k8_ms"] = ms(
        lambda: kernels.assign_packed(rgb, cents, 0.0, metric="cie2000"), 10)
    out["lloyd_cie2000_k8_ms"] = ms(
        lambda: kernels.lloyd_accumulate(planes, cents, n_valid, metric="cie2000"), 10)
    cents = palette(2048)
    out["rgba_k2048_ms"] = ms(lambda: kernels.quantize_rgba(rgb, cents, 0.0), 3)
    if args.fast:
        for k in (64, 256):
            cents = palette(k)
            for metric in ("cie94", "cie2000"):
                out[f"assign_fast_{metric}_k{k}_ms"] = ms(
                    lambda: kernels.assign_packed(rgb, cents, 0.0, metric=metric, fast=True), 5)
                out[f"lloyd_fast_{metric}_k{k}_ms"] = ms(
                    lambda: kernels.lloyd_accumulate(planes, cents, n_valid, metric=metric,
                                                     fast=True), 5)
            out[f"lloyd_fast_cie94_inertia_k{k}_ms"] = ms(
                lambda: kernels.lloyd_accumulate(planes, cents, n_valid, emit_inertia=True,
                                                 fast=True), 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
