"""The benchmark's machinery: cells, their files found by name, the closed
loop that drives the program, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell's check is a file of its own, found by the name that
`BENCHMARK.json` gives it:

- `configs/<config>.json`: the deployment (image shape, recipe, processor
  options);
- `traffic/<traffic>.json`: the mix (the entry point called, its colour
  count and mode, processor options of the mix, the pool size); one
  caller in a closed loop;
- `metrics/<metric>.py`: a reader `read(run) -> float | None` of one
  metric from a `Run`; None leaves the metric out of the line;
- `limits/<workload>.json`: the numbers that decide `correct`, each with
  its limit, the sample of calls compared, and the control.

The program under test is `kmeans_tpu_torch`, imported only inside the
functions that drive it.
"""

from __future__ import annotations

import importlib.util
import json
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(folder: str, name: str, suffix: str) -> Path:
    path = HERE / folder / f"{name}{suffix}"
    if "/" in name or not path.is_file():
        raise KeyError(f"no {folder[:-1] if folder.endswith('s') else folder} named {name!r} "
                       f"({path.relative_to(ROOT)} not found)")
    return path


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(_named("configs", name, ".json"))


def load_traffic(name: str) -> dict:
    return load_json(_named("traffic", name, ".json"))


def load_limits(workload: str) -> dict:
    return load_json(_named("limits", workload, ".json"))


def load_reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = _named("metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end ones
    untraced, the per-layer ones traced, each where its `workloads` (if
    any) lists the cell."""
    entries = bench["per_layer" if traced else "end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


@dataclass
class Cell:
    """One workload with its configuration, traffic and limits."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict

    @classmethod
    def load(cls, bench: dict, name: str) -> Cell:
        w = find_workload(bench, name)
        return cls(name, int(w["chips"]), load_config(w["config"]),
                   load_traffic(w["traffic"]), load_limits(name))

    def processor_options(self) -> dict:
        return {**self.config.get("processor", {}), **self.traffic.get("processor", {})}


@dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    setup_s: float = 0.0
    # (pool index, seconds, output pixels) of each call of the window
    calls: list = field(default_factory=list)
    window_s: float = 0.0
    window_peak_bytes: int = 0
    # phase -> seconds over the window's calls (traced runs only)
    phases: dict = field(default_factory=dict)
    # Lloyd iterations of each call of the window (traced runs only)
    iterations: list = field(default_factory=list)
    trace: object = None  # trace.Trace of one profiled cycle of the pool
    profiled_pixels: int = 0


def call_entry(processor, traffic: dict, item) -> list:
    """One call of the traffic's entry point on `item`; the output RGBA
    arrays, one per frame."""
    k, mode = traffic["colors"], traffic["mode"]
    if traffic["call"] == "reduce":
        return [processor.reduce(k, item, reduce_mode=mode).pixels]
    if traffic["call"] == "reduce_images":
        return [im.pixels for im in processor.reduce_images(item, k, reduce_mode=mode)]
    raise KeyError(f"unknown call {traffic['call']!r}")


class Sample:
    """A uniform sample of `size` calls of the window, drawn from the seed
    (reservoir sampling): `(call index, pool index, outputs)`."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept, self.seen = size, random.Random(seed), [], 0

    def offer(self, pool_index: int, outputs: list) -> None:
        entry = (self.seen, pool_index, outputs)
        if len(self.kept) < self.size:
            self.kept.append(entry)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = entry
        self.seen += 1


def drive(processor, cell: Cell, pool: list, seconds: float, sample: Sample, traced: bool,
          run: Run, sync) -> int:
    """The closed loop: one caller sends pool item after pool item, each
    call after the last one's output is on the host, until `seconds` have
    passed; the last call completes. Records into `run`; returns the count
    of calls that raised."""
    from kmeans_tpu_torch.utils.profiling import collect_phases

    from gpubench.images import pixels_of

    failed = 0
    start = time.perf_counter()
    i = 0
    while True:
        j = i % len(pool)
        t = time.perf_counter()
        try:
            if traced:
                with collect_phases(run.phases):
                    outputs = call_entry(processor, cell.traffic, pool[j])
                run.iterations.append(processor.last_iterations)
            else:
                outputs = call_entry(processor, cell.traffic, pool[j])
        except Exception as exc:  # noqa: BLE001 - a failed call is counted and reported
            failed += 1
            outputs = None
            print(f"call {i} failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        done = time.perf_counter()
        run.calls.append((j, done - t, pixels_of(pool[j]) if outputs is not None else 0))
        if outputs is not None:
            sample.offer(j, outputs)
        i += 1
        if done - start >= seconds:
            break
    sync()
    run.window_s = time.perf_counter() - start
    return failed


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> dict:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line
