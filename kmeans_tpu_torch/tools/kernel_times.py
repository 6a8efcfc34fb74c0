"""Time the port's kernels of one or more checkouts on a card, in turns.

    python3 kmeans_tpu_torch/tools/kernel_times.py [--fast] [--modes GROUPS] [CHECKOUT ...]

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

`--modes` names the groups to time, comma-separated (default `main`, the
modes above; `--fast` adds `fast`):

- `threshold`: the dither threshold kernel at k = 1, 8, 2048 and 16384
  under both metrics, on seeded random palettes and on the palette whose
  every step updates the walk (`tools/threshold_walk.py::every_step_palette`,
  `_every_step_` in the name), and 16 random palettes at k = 2048 in one
  launch. A line `threshold_updates` gives each palette's updates (counted
  on the card by `threshold_walk.count_updates`), and
  a line per checkout `threshold_floor_ms` its latency floor: the launch
  and the first distance (the k = 1 time) plus one step of the
  every-step palette per update ((t(16384) - t(8)) / 16376 of that
  checkout: one dependent round).
- `mxu`: the experiment tool's factor-mxu and factor-vpu at k = 64 and
  256 on the tool's data (`tools/exp_mxu.py`), and factor-vpu on the
  trained CIE94 palettes above (`_trained_`), each checkout through its
  own tool module and its own `tools/csrc/` library. factor-mxu's TF32
  sums may flip near-ties between two kernels, so its lines give
  `flips_vs_first` and `flips_are_near_ties` against the first checkout
  instead of `same_outputs`.
- `gather`: B10 (`tools/exp_gather.py`), each checkout through its own
  tool module and its own `tools/csrc/` library, as `mxu`: the single
  read at `[128, 128]` by each table placement against `torch.take` and
  an empty kernel (the launch floor, this checkout's library), 50
  launches each a pass; the sums of 8 reads by each placement, the pow
  sum and a copy of the same bytes (`Tensor.copy_`, what the card's
  memory allows) over the 4K grid, 20 launches each a pass; two passes
  (the garbage collector off), the forms in one order and then the
  other, each launch after the L2 flush and a ~0.5 ms spin of the card
  (the host's time to enqueue it) and timed alone: mean, median,
  standard deviation, least and most.
  Where the checkout's tool has `fill_constant`, the constant
  placement's fill alone the same way; and the device operations one
  constant-placement call runs with its table resident
  (`_exp.device_ops`: one kernel, or a copy and a kernel).

A last line, `{"same_outputs": {mode: bool}}`, says for each mode whether
every checkout's output equals the first one's bit for bit.
"""

import argparse
import ctypes
import gc
import hashlib
import importlib.util
import json
import statistics
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


def add_main(add, rgb, hd, frames, planes, n_valid, palette):
    """The exact kernels' modes (the default group)."""
    import torch

    from kmeans_tpu_torch.ops import kernels

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


def add_fast(add, rgb, frames, planes, n_valid, palette, dev):
    """The fast tiers' modes (`--fast`)."""
    import torch

    from kmeans_tpu_torch.ops import kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab

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
    image, palettes = trained_palettes(dev)
    grad = torch.from_numpy(np.ascontiguousarray(image[..., :3])).to(dev)
    grad_planes, grad_valid = kernels.pack_lab_planes(srgb8_to_lab(grad.reshape(-1, 3)))
    for k in (64, 256):
        for metric in ("cie94", "cie2000"):
            cents = palettes[metric, k]
            add(f"assign_fast_{metric}_trained_k{k}", lambda c=cents, m=metric:
                kernels.assign_packed(grad, c, 0.0, metric=m, fast=True), 5)
            add(f"meld_fast_{metric}_trained_k{k}", lambda c=cents, m=metric:
                kernels.meld_packed(grad, c, metric=m, fast=True), 5)
            add(f"lloyd_fast_{metric}_trained_k{k}", lambda c=cents, m=metric:
                kernels.lloyd_accumulate(grad_planes, c, grad_valid, metric=m, fast=True), 5)
        add(f"lloyd_fast_cie94_inertia_trained_k{k}", lambda c=palettes["cie94", k]:
            kernels.lloyd_accumulate(grad_planes, c, grad_valid, emit_inertia=True, fast=True), 5)
    cents = torch.stack([palette(64) for _ in range(16)])
    for metric in ("cie94", "cie2000"):
        add(f"assign_frames_fast_{metric}_k64", lambda c=cents, m=metric:
            kernels.assign_frames_packed(frames, c, 0.0, metric=m, fast=True), 3)
        add(f"meld_frames_fast_{metric}_k64", lambda c=cents, m=metric:
            kernels.meld_frames_packed(frames, c, metric=m, fast=True), 3)


_TRAINED = {}


def trained_palettes(dev):
    """`chip_smoke.py`'s 4K gradient-plus-noise RGBA image (numpy) and the
    palettes `ImageProcessor` trains on it, `{(metric, k): centroids}` at
    k = 64 and 256 under both metrics; trained once a process."""
    if not _TRAINED:
        from chip_smoke import synthetic_image
        from kmeans_tpu_torch import Image, ImageProcessor

        image = synthetic_image(2160, 3840)
        _TRAINED["image"] = image
        for k in (64, 256):
            for metric, delta_e in (("cie94", "94"), ("cie2000", "2000")):
                _TRAINED[metric, k] = ImageProcessor(
                    device="cuda", delta_e=delta_e).extract_palette_kmeans(
                        Image((3840, 2160), image), k).contiguous()
    return _TRAINED["image"], _TRAINED


THRESHOLD_KS = (1, 8, 2048, 16384)
THRESHOLD_FRAMES = 16


def add_threshold(add, dev) -> dict:
    """The threshold kernel's modes; returns `{mode: (palette, metric)}`
    of the single palettes, whose updates `main` counts."""
    import torch

    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.ops.quantize import dither_threshold, dither_thresholds
    from kmeans_tpu_torch.tools.threshold_walk import every_step_palette

    rng = np.random.default_rng(9)

    def palette(k):
        colors = torch.from_numpy(rng.integers(0, 256, (k, 3), dtype=np.uint8)).to(dev)
        return srgb8_to_lab(colors).contiguous()

    walks = {}
    for metric in ("cie94", "cie2000"):
        for k in THRESHOLD_KS:
            for kind, pal in (("random", palette(k)), ("every_step", every_step_palette(k, dev))):
                if kind == "every_step" and k == 1:
                    continue
                mode = f"threshold_{metric}_{kind}_k{k}"
                reps = 3 if k == 16384 and metric == "cie2000" else 10 if k == 16384 else 20
                add(mode, lambda p=pal, m=metric: dither_threshold(p, metric=m), reps)
                walks[mode] = (pal, metric)
        pals = torch.stack([palette(2048) for _ in range(THRESHOLD_FRAMES)])
        add(f"threshold_{metric}_{THRESHOLD_FRAMES}x_k2048",
            lambda p=pals, m=metric: dither_thresholds(p, None, m), 10)
    return walks


def add_mxu(add, dev) -> dict:
    """factor-vpu and factor-mxu on the tool's data, by each checkout's
    own tool module; returns `{mode: (image, centroids)}`."""
    import torch

    from kmeans_tpu_torch.tools import exp_mxu

    rng = np.random.default_rng(0)  # the tool's data, drawn in its order
    img = torch.from_numpy(exp_mxu.random_image(exp_mxu.HEIGHT, exp_mxu.WIDTH, rng)).to(dev)
    data = {}
    for kp in exp_mxu.KS:
        cents = torch.from_numpy(exp_mxu.random_centroids(kp, rng)).to(dev)
        add(f"factor_vpu_k{kp}", lambda mod, c=cents: mod.factor_vpu(img, c), 10, "exp")
        add(f"factor_mxu_k{kp}", lambda mod, c=cents: mod.factor_mxu(img, c), 10, "near_ties")
        data[f"factor_mxu_k{kp}"] = (img, cents)
    # factor-vpu on the palettes users meet (`trained_palettes`, CIE94).
    image, palettes = trained_palettes(dev)
    grad = torch.from_numpy(image).to(dev)
    for kp in exp_mxu.KS:
        add(f"factor_vpu_trained_k{kp}", lambda mod, c=palettes["cie94", kp]:
            mod.factor_vpu(grad, c), 10, "exp")
    return data


def time_gather(eg, floor_lib, dev, flush) -> tuple[dict, dict]:
    """B10 through one checkout's tool module `eg` (over its own library):
    `({"gather_ms": ..., "lut_ms": ..., ...}, {mode: output})`. Each form
    runs once for its output, then in two passes (one order, then the
    other), each launch timed alone after the flush."""
    import torch

    from chip_smoke import GATHER_HEADROOM_CYCLES
    from kmeans_tpu_torch.tools import _exp

    table = eg.gamma_table(dev)
    idx = torch.from_numpy(eg.gather_indices()).to(dev)
    idx_long = idx.long()  # torch.take indexes by int64
    grid = torch.from_numpy(eg.grid_indices(np.random.default_rng(3))).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    groups = {"gather_ms": {p: (lambda p=p: eg.gather(table, idx, p)) for p in eg.PLACEMENTS},
              "lut_ms": {p: (lambda p=p: eg.lut_sum(table, grid, p)) for p in eg.PLACEMENTS}}
    groups["gather_ms"]["take"] = lambda: torch.take(table, idx_long)
    groups["gather_ms"]["empty"] = lambda: _exp.check(floor_lib, floor_lib.exp_empty(stream),
                                                      "exp_empty")
    groups["lut_ms"]["pow"] = lambda: eg.pow_sum(grid)
    # The sums' bytes moved by a plain copy: what the card's memory allows.
    copied = torch.empty(grid.shape, dtype=torch.float32, device=dev)
    groups["lut_ms"]["copy"] = lambda: copied.copy_(grid.view(torch.float32))
    if hasattr(eg, "fill_constant"):
        groups["fill_ms"] = {"constant": lambda: eg.fill_constant(table)}
    reps = {"gather_ms": 50, "lut_ms": 20, "fill_ms": 50}
    forms = [(g, name, fn) for g, fns in groups.items() for name, fn in fns.items()]
    outputs = {}
    for g, name, fn in forms:
        got = fn()
        if g != "fill_ms" and name not in ("empty", "copy"):
            outputs[f"{g[:-3]}_{name}"] = got
        fn()  # with the first output held, this one leaves a block in the allocator's cache
    torch.cuda.synchronize()
    ops = _exp.device_ops(groups["gather_ms"]["constant"])
    times = {(g, name): [] for g, name, _ in forms}
    gc.disable()  # a collection inside a timed span would be timed with it
    for turn in (forms, forms[::-1]):
        for g, name, fn in turn:
            pairs = []
            for _ in range(reps[g]):
                flush.zero_()
                torch.cuda._sleep(GATHER_HEADROOM_CYCLES)  # the host's time to enqueue fn
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize()
            times[g, name] += [s.elapsed_time(e) for s, e in pairs]
    gc.enable()
    line = {g: {} for g in groups}
    for (g, name), t in times.items():
        line[g][name] = {"mean": statistics.fmean(t), "median": statistics.median(t),
                         "stdev": statistics.stdev(t), "min": min(t), "max": max(t),
                         "launches": len(t)}
    line["constant_gather_device_ops"] = ops
    return line, outputs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkouts", nargs="*", default=[str(ROOT)])
    parser.add_argument("--fast", action="store_true", help="also time the fast tiers")
    parser.add_argument("--modes", default="main",
                        help="groups to time: main, fast, threshold, mxu, gather")
    args = parser.parse_args()
    groups = set(args.modes.split(",")) | ({"fast"} if args.fast else set())

    import torch

    from kmeans_tpu_torch.ops import _build, kernels
    from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
    from kmeans_tpu_torch.tools import _exp

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    roots = [Path(c).resolve() for c in args.checkouts]
    trees = sorted(set(roots))

    def build(root):
        tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
        return _build.build(root / "kmeans_tpu_torch" / "csrc", f"kernel_times_{tag}")

    def build_exp(root):
        tag = hashlib.sha256(str(root).encode()).hexdigest()[:8]
        pkg = root / "kmeans_tpu_torch"
        return _build.build(pkg / "tools" / "csrc", f"kernel_times_exp_{tag}", pkg / "csrc")

    exp_groups = groups & {"mxu", "gather"}
    with ThreadPoolExecutor(4) as pool:
        # `gather` alone needs no main library.
        paths = (dict(zip(trees, pool.map(build, trees)))
                 if groups - {"gather"} else {})
        exp_paths = dict(zip(trees, pool.map(build_exp, trees))) if exp_groups else {}
        floor_path = pool.submit(_exp.build_exp_library) if "gather" in groups else None
    # Each checkout's own experiment tool modules, over its own library,
    # declared by its own `_exp`.
    exp_tools = {}
    for i, (root, path) in enumerate(exp_paths.items()):
        lib = ctypes.CDLL(str(path))
        tools = root / "kmeans_tpu_torch" / "tools"
        _load(f"kernel_times_exp_{i}", tools / "_exp.py")._declare(lib)
        exp_tools[root] = (lib, {g: _load(f"kernel_times_exp_{g}_{i}", tools / f"exp_{g}.py")
                                 for g in exp_groups})
    floor_lib = None
    if floor_path is not None:
        floor_lib = ctypes.CDLL(str(floor_path.result()))
        _exp._declare(floor_lib)
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

    if groups & {"main", "fast"}:
        rgb = rgb_image(2160, 3840)
        hd = rgb_image(1080, 1920)
        frames = torch.stack([rgb_image(1080, 1920) for _ in range(16)])
        planes, n_valid = kernels.pack_lab_planes(srgb8_to_lab(rgb.reshape(-1, 3)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    # (mode, call, launches timed, kind): every palette drawn once, before
    # the turns. A call of kind "exp" takes the checkout's tool module; of
    # kind "near_ties" also, and its output is compared by near-ties.
    calls = []

    def add(mode, fn, reps, kind="main"):
        calls.append((mode, fn, reps, kind))

    if "main" in groups:
        add_main(add, rgb, hd, frames, planes, n_valid, palette)
    if "fast" in groups:
        add_fast(add, rgb, frames, planes, n_valid, palette, dev)
    walks, updates, mxu_data = {}, {}, {}
    if "threshold" in groups:
        from kmeans_tpu_torch.tools.threshold_walk import count_updates

        walks = add_threshold(add, dev)
        for mode, (pal, metric) in walks.items():
            updates[mode] = count_updates(pal, metric)
        print(json.dumps({"threshold_updates": updates}), flush=True)
    if "mxu" in groups:
        from kmeans_tpu_torch.tools import exp_mxu

        mxu_data = add_mxu(add, dev)

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
    digests, first_out, flips = {}, {}, {}

    def digest(mode, got):
        digests.setdefault(mode, set()).add(hashlib.sha256(
            got.reshape(-1).contiguous().view(torch.uint8).cpu().numpy()).hexdigest())

    for root in roots:
        if root in libs:
            _build._libs[_build.MAIN_NAME] = libs[root]
        if root in exp_tools:
            _build._libs[_exp.EXP_NAME] = exp_tools[root][0]
        out = {"checkout": str(root), "card": card}
        for mode, fn, reps, kind in calls:
            call = fn if kind == "main" else (lambda fn=fn: fn(exp_tools[root][1]["mxu"]))
            got = call()
            torch.cuda.synchronize()
            if kind == "near_ties":
                if mode not in first_out:
                    first_out[mode] = got
                else:
                    img, cents = mxu_data[mode]
                    flips.setdefault(mode, []).append(exp_mxu.near_ties(
                        img, cents, got, first_out[mode], tf32=True))
            else:
                digest(mode, got)
            out[f"{mode}_ms"] = ms(call, reps)
        if "gather" in groups:
            line, outputs = time_gather(exp_tools[root][1]["gather"], floor_lib, dev, flush)
            out.update(line)
            for mode, got in outputs.items():
                digest(mode, got)
        print(json.dumps(out), flush=True)
        if walks:
            print(json.dumps({"threshold_floor_ms": threshold_floor(out, updates)}), flush=True)
    _build._libs.pop(_build.MAIN_NAME, None)
    _build._libs.pop(_exp.EXP_NAME, None)
    if flips:
        print(json.dumps({"flips_vs_first": {m: [f for f, _ in v] for m, v in flips.items()},
                          "flips_are_near_ties": {m: all(n for _, n in v)
                                                  for m, v in flips.items()}}), flush=True)
    print(json.dumps({"same_outputs": {mode: len(d) == 1 for mode, d in digests.items()}}),
          flush=True)
    return 0


def _load(name: str, path: Path):
    """The module of the file `path`, under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def threshold_floor(times: dict, updates: dict) -> dict:
    """Each threshold mode's latency floor from one checkout's times: the
    k = 1 launch plus one every-step round per update."""
    floors = {}
    for metric in ("cie94", "cie2000"):
        big, small = (f"threshold_{metric}_every_step_k{k}_ms" for k in (16384, 8))
        step = (times[big] - times[small]) / (16384 - 8)
        launch = times[f"threshold_{metric}_random_k1_ms"]
        floors[f"{metric}_step"] = step
        for mode, n in updates.items():
            if f"_{metric}_" in mode:
                floors[mode] = launch + n * step
    return floors


if __name__ == "__main__":
    sys.exit(main())
