"""One run of one cell of the benchmark of `kmeans_tpu_torch` on CUDA.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the cell in `BENCHMARK.json`, loads
its configuration, traffic and limits by name, makes the cell's image pool
from `--seed` on the card, warms the cell's shapes (set-up, `setup_s`),
drives the closed loop for `--seconds`, and checks a sample of the
window's outputs drawn from the seed against the plain reference
(`gpubench/reference/`), run after the window with TF32 off. The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics; with `--trace 1` its per-layer
metrics, read from the window with the program's phase recorder on and one
profiled cycle of the pool), `device`, with `--trace 1` `breakdown`, and
`checks`, each compared number beside its limit (also the last lines of
standard error).

It exits with a code other than 0 and prints no result when no CUDA card
is there, or fewer than the cell asks for, and when a module of JAX or of
the JAX package is loaded once the window has closed. Build and kernel
caches live under the checkout's `build/`.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from gpubench.harness import ROOT  # noqa: E402

CACHE = ROOT / "build" / "gpubench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "kmeans_tpu"}


def _fixed_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules (default: `sys.modules`) that are
    JAX's or the JAX package's, each name compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules if modules is None else modules)}
                  & FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def fail(message: str, code: int) -> None:
    print(message, file=sys.stderr, flush=True)
    sys.exit(code)


def measure(cell, seed: int, seconds: float, traced: bool, device):
    """Set-up and window of one run of `cell` on `device`: the pool from
    `seed`, the warm calls, the closed loop, and under `traced` one profiled
    cycle of the pool (CUDA only). Returns `(run, pool, sample, failed,
    setup peak bytes)`."""
    import torch

    import kmeans_tpu_torch as kt
    from gpubench import harness, images
    from gpubench.trace import profile_calls

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pool = images.make_pool(cell.config, cell.traffic["pool"], seed, device)
    processor = kt.ImageProcessor(device=device, **cell.processor_options())
    for item in pool[:min(2, len(pool))]:
        harness.call_entry(processor, cell.traffic, item)
    sync()
    run = harness.Run(cell=cell, setup_s=time.perf_counter() - T0)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sample = harness.Sample(cell.limits["sample_calls"], seed)
    failed = harness.drive(processor, cell, pool, seconds, sample, traced, run, sync)
    run.window_peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced and cuda:
        run.trace = profile_calls(lambda item: harness.call_entry(processor, cell.traffic, item),
                                  pool)
        run.profiled_pixels = sum(images.pixels_of(item) for item in pool)
    return run, pool, sample, failed, setup_peak


def check(cell, pool, sample, device):
    """Each sampled output against the plain reference's, on `device` with
    TF32 off. Returns `(correct by the limits, checks, numbers)`."""
    import torch

    from gpubench import judge, reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_max_size = cell.processor_options()["train_max_size"]
    ref_call = reference.CALLS[cell.traffic["call"]]
    pairs, refs = [], {}
    for _, j, outputs in sample.kept:
        if j not in refs:
            refs[j] = ref_call(pool[j], cell.traffic["colors"], cell.traffic["mode"],
                               train_max_size, device).reshape(
                                   -1, *outputs[0].shape).cpu().numpy()
        pairs.extend(zip(outputs, refs[j]))
    values = judge.numbers(pairs)
    correct, checks = judge.verdict(values, cell.limits)
    return correct and len(pairs) > 0, checks, values


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _fixed_caches()

    import torch

    from gpubench import harness
    from gpubench.trace import top

    bench = harness.load_benchmark()
    cell = harness.Cell.load(bench, args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs only on a CUDA card", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} found", 3)
    traced = bool(args.trace)
    seed = args.seed % (1 << 63)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run, pool, sample, failed, setup_peak = measure(cell, seed, args.seconds, traced, device)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, run.window_peak_bytes)),
                   "power_limit_w": power_limit_w()}
    breakdown = None
    if traced:
        device_info["busy_s"] = run.trace.busy_us / 1e6
        device_info["window_s"] = run.trace.window_us / 1e6
        breakdown = {"device_ops": top(run.trace.device_ops, value=lambda v: v[1]),
                     "idle_gaps": top(run.trace.idle_by_host)}
    metrics = {}
    for entry in harness.cell_metrics(bench, cell.name, traced):
        value = harness.load_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    torch.cuda.empty_cache()
    correct, checks, values = check(cell, pool, sample, device)
    correct = correct and failed == 0
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package loaded: {', '.join(found)}", 4)
    print(json.dumps({"sampled_calls": [c for c, _, _ in sample.kept], "numbers": values}),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    line = harness.result_line(correct, len(run.calls), failed, metrics, device_info, checks,
                               breakdown)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
