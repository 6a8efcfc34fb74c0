"""Time the port's main path, end to end, for one or more checkouts on a
card, in turns.

    python3 kmeans_tpu_torch/tools/reduce_times.py [--rounds N] [--fast-palette] [CHECKOUT ...]

runs, for each CHECKOUT in the order given (default: this file's
checkout), a fresh Python process that imports that checkout's
`kmeans_tpu_torch` (building its CUDA library into that checkout's
`build/` on first use) and times `ImageProcessor(device="cuda").reduce(8,
image, KMEANS, mode)` on the 3840x2160 gradient-plus-noise image of
`chip_smoke.py` (seed 0) for replace and meld, in turns: `--rounds` calls
each (default 8), the first dropped as warm-up, on the host's clock
around a call that ends in its readback, with the phases of
`utils/profiling.py::collect_phases`. To compare two trees on one card,
unpack the other one (`git archive`) into an ignored directory and pass
both in turns, `PARENT . . PARENT`: host time moves between calls and
machines, so only turns inside one call compare. Each turn prints one
JSON line per mode: the checkout, the card's name and power limit, the
median milliseconds and each call's, and the median of each phase.

`--fast-palette` times instead the fast slice's heaviest full-resolution
call, `ImageProcessor(device="cuda", fast=True, train_max_size=None,
delta_e="2000").palette(256, image)` (one pruned-CIEDE2000 accumulator
launch a Lloyd iteration), with its launches and iterations.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("host_prep", "upload", "device", "lloyd_sync", "readback", "unpack")


def synthetic_image(height: int, width: int, seed: int = 0):
    """`chip_smoke.py`'s image: a gradient plus uniform noise in [-8, 8],
    RGBA with alpha 255."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    rgb = np.stack(
        [x * 255 // width, y * 255 // height, (x + y) * 255 // (width + height)], axis=-1,
    ).astype(np.uint8)
    rgb = np.clip(rgb.astype(int) + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((height, width, 1), 255, np.uint8)], axis=-1)


def one_turn(checkout: str, rounds: int, card: str, fast_palette: bool = False) -> None:
    """Time one checkout (an absolute path) in this process, its package
    first on the path."""
    sys.path.insert(0, checkout)
    from kmeans_tpu_torch import ImageProcessor, ReduceMode
    from kmeans_tpu_torch.utils.profiling import collect_phases

    image = synthetic_image(2160, 3840)
    if fast_palette:
        time_fast_palette(checkout, rounds, card, image)
        return
    proc = ImageProcessor(device="cuda")
    modes = {"replace": ReduceMode.REPLACE, "meld": ReduceMode.MELD}
    runs = {mode: [] for mode in modes}
    for _ in range(rounds):
        for mode, reduce_mode in modes.items():
            phases: dict = {}
            t0 = time.perf_counter()
            with collect_phases(phases):
                proc.reduce(8, image, reduce_mode=reduce_mode)
            runs[mode].append(((time.perf_counter() - t0) * 1e3, phases))
    for mode, results in runs.items():
        warm = results[1:]
        print(json.dumps({
            "checkout": checkout, "card": card,
            "what": f"reduce 3840x2160 k=8 {mode}, median of {len(warm)} warm",
            "e2e_ms": statistics.median(r[0] for r in warm),
            "e2e_ms_each": [r[0] for r in warm],
            "phases_ms": {p: statistics.median(r[1].get(p, 0.0) for r in warm) * 1e3
                          for p in PHASES},
        }), flush=True)


def time_fast_palette(checkout: str, rounds: int, card: str, image) -> None:
    """The full-resolution `palette(256)` under `delta_e="2000"` and
    `fast=True`: median host milliseconds of the warm calls (each ends in
    its readback), its accumulator launches and Lloyd iterations."""
    from kmeans_tpu_torch import ImageProcessor
    from kmeans_tpu_torch.ops import kernels

    proc = ImageProcessor(device="cuda", fast=True, train_max_size=None, delta_e="2000")
    runs = []
    for _ in range(rounds):
        before = kernels.launches("lloyd_accumulate")
        t0 = time.perf_counter()
        proc.palette(256, image)
        runs.append(((time.perf_counter() - t0) * 1e3,
                     kernels.launches("lloyd_accumulate") - before))
    warm = runs[1:]
    print(json.dumps({
        "checkout": checkout, "card": card,
        "what": f"palette(256) 3840x2160 fast, delta_e=2000, full resolution, median of "
                f"{len(warm)} warm",
        "e2e_ms": statistics.median(r[0] for r in warm), "e2e_ms_each": [r[0] for r in warm],
        "lloyd_launches_each": [r[1] for r in warm], "iterations": proc.last_iterations,
    }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkouts", nargs="*", default=[str(ROOT)])
    parser.add_argument("--rounds", type=int, default=8)
    parser.add_argument("--fast-palette", action="store_true",
                        help="time the full-resolution fast palette(256) under CIEDE2000")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    parser.add_argument("--card", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one_turn(args.one, args.rounds, args.card, args.fast_palette)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for checkout in args.checkouts:
        path = str(Path(checkout).resolve())
        subprocess.run([sys.executable, __file__, "--one", path, "--rounds",
                        str(args.rounds), "--card", card]
                       + (["--fast-palette"] if args.fast_palette else []), check=True, cwd=path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
