"""Count and time the main path's farthest-point seeding for one or more
checkouts on a card, in turns.

    python3 kmeans_tpu_torch/tools/seed_launches.py [--rounds N] [CHECKOUT ...]

runs, for each CHECKOUT in the order given (default: this file's
checkout), a fresh Python process that imports that checkout's
`kmeans_tpu_torch` and seeds as its `api._train` seeds the 3840x2160
`chip_smoke.py` image at k=8: the training shrink, Lab, then
`models/kmeans.py::plusplus_init`, with the compiled-form seed side
(`seed_lab`) where the checkout has one. It prints one JSON line per
checkout: the card's name and power limit, the CUDA kernel launches and
copies of one seeding as `torch.profiler` records them, the ATen
operations it dispatches, and the median milliseconds of `--rounds` warm
seedings (CUDA events). To compare with a parent, unpack it (`git
archive`) into an ignored directory and pass `PARENT . . PARENT`.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
K = 8


def one_turn(checkout: str, rounds: int, card: str) -> None:
    """Count and time one checkout's seeding in this process, its package
    first on the path."""
    sys.path.insert(0, checkout)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from kmeans_tpu_torch.models import kmeans as km
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.resize import resize_uint8, shrunk_dimensions
    from kmeans_tpu_torch.tools.reduce_times import synthetic_image

    image = torch.from_numpy(synthetic_image(2160, 3840)[..., :3].copy()).cuda()
    sw, sh = shrunk_dimensions(3840, 2160, 256)
    rgb = resize_uint8(image, sh, sw).reshape(-1, 3)
    work = srgb8_to_lab(rgb)
    first = km.reference_seed_index(sw, sh)
    has_seed = hasattr(km, "seed_lab")

    def seeding():
        if has_seed:
            return km.plusplus_init(work, K, first, seed=km.seed_lab(rgb))
        return km.plusplus_init(work, K, first)

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))

    seeding()
    torch.cuda.synchronize()
    with Ops():
        seeding()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        seeding()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(1 for n in names if n.startswith(("Memcpy", "Memset")))
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        seeding()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(json.dumps({
        "checkout": checkout, "card": card,
        "what": f"plusplus_init of the 3840x2160 training shrink ({sw}x{sh}) at k={K}",
        "seed_side": has_seed, "kernel_launches": len(names) - copies, "copies": copies,
        "aten_ops": Ops.n, "ms_median": statistics.median(times), "ms_each": times,
    }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkouts", nargs="*", default=[str(ROOT)])
    parser.add_argument("--rounds", type=int, default=20)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    parser.add_argument("--card", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one_turn(args.one, args.rounds, args.card)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for checkout in args.checkouts:
        path = str(Path(checkout).resolve())
        subprocess.run([sys.executable, __file__, "--one", path, "--rounds",
                        str(args.rounds), "--card", card], check=True, cwd=path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
