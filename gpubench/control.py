"""Readings for the limits that decide `correct`: the program's sound runs
and the control, on many seeds in one process, at the cell's own sizes.

    python3 -m gpubench.control --workload <cell> --seeds 11,12,13 [--items 2] [--control]

For each seed it makes the cell's pool, runs the program's call on the
first `--items` pool items (default all) and compares each output with the
plain reference's (`judge.numbers`). With `--control` it also runs the
cell's control (`limits/<cell>.json` `"control"`): `reference_lowp`, the
reference in bfloat16 put in the program's place, or `program`, the
program with the processor options given there (its own lower-precision
path), and compares that with the float32 reference. One JSON line a seed
on standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from gpubench import harness, images, judge, reference


def colours_apart(got, want) -> int:
    """Distinct colours of `got` that `want` does not hold: palette entries
    that came out another u8 colour than the reference's."""
    def colours(a):
        a = np.asarray(a)[..., :3].astype(np.uint32)
        return np.unique((a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2])
    return int(np.setdiff1d(colours(got), colours(want)).size)


def readings(cell, seed: int, items, control: bool, device) -> dict:
    import torch

    import kmeans_tpu_torch as kt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = images.make_pool(cell.config, cell.traffic["pool"], seed, device)
    chosen = pool if items is None else pool[:items]
    processor = kt.ImageProcessor(device=device, **cell.processor_options())
    spec = cell.limits["control"]
    lowered = (kt.ImageProcessor(device=device, **{**cell.processor_options(),
                                                   **spec.get("processor", {})})
               if control and spec["kind"] == "program" else None)
    ref_call = reference.CALLS[cell.traffic["call"]]
    args = (cell.traffic["colors"], cell.traffic["mode"],
            cell.processor_options()["train_max_size"], device)
    line = {"workload": cell.name, "seed": seed, "items": []}
    for item in chosen:
        t = time.perf_counter()
        outs = harness.call_entry(processor, cell.traffic, item)
        entry = {"program_s": time.perf_counter() - t, "program_iterations":
                 processor.last_iterations}
        details = {}
        t = time.perf_counter()
        ref = ref_call(item, *args, details=details).reshape(-1, *outs[0].shape).cpu().numpy()
        entry["reference_s"] = time.perf_counter() - t
        entry["reference_steps"] = details["steps"]
        entry["program"] = judge.numbers(zip(outs, ref))
        entry["colours_apart"] = [colours_apart(o, r) for o, r in zip(outs, ref)]
        if control:
            if lowered is not None:
                low = harness.call_entry(lowered, cell.traffic, item)
            else:
                low = ref_call(item, *args, lowp=True).reshape(-1, *outs[0].shape).cpu().numpy()
            entry["control"] = judge.numbers(zip(low, ref))
        line["items"].append(entry)
    return line


def main(argv=None) -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--items", type=int, default=None)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    cell = harness.Cell.load(harness.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.items, args.control, device)), flush=True)


if __name__ == "__main__":
    main()
