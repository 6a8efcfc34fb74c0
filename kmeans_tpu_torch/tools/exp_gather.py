"""Hardware experiment: a 256-entry table read against `powf`, by where the
table lives.

Port of `tools/exp_gather.py`. The reference asks which 2-D gather forms
its TPU compiler lowers; on Hopper the question is where a 256-entry
float32 table lives when every element reads it at a random index. One
kernel (`tools/csrc/exp_gather.cu`) reads it from each `PLACEMENTS` entry:

- `shared`: staged in shared memory by every block, as the port's kernels
  B1-B7 stage the gamma table. Random indices collide on the 32 banks.
- `constant`: `__constant__` memory. Different indices in a warp
  serialise.
- `global`: device memory through the read-only cache (`__ldg`).

Three uses, each with a plain twin:

- `gather` (the reference's `try_form:48`, body `kernel:52`): the table's
  value at each index, `[128, 128]` int32 indices (seed 3). Every
  placement must return the table's bits: the table is numpy's float32
  `(i / 255) ** 2.4`, carried as bits (`gamma_table`), never recomputed.
- `lut_sum` (`lut_kernel:152`): `acc = 0; acc += table[(idx + j) & 255]`
  for j = 0..7, over the 4K-sized `[64896, 128]` int32 grid
  (8,306,688 elements). Equal to its twin bit for bit (the same adds in
  the same order).
- `pow_sum` (`pow_kernel:160`): the same sum of the sRGB transfer,
  `c = ((idx + j) & 255) / 255`, then `((c + 0.055) / 1.055) ** 2.4` above
  0.04045, else `c / 12.92`, with true divides and `powf`. As in the
  reference, it computes another function than the table (the sRGB curve,
  not a plain 2.4 power): only the two sums' times compare.

`pow_table` gives `powf(i / 255, 2.4)` for i < 256, to count its ulps
against the numpy table. On a CPU tensor each wrapper runs its twin; on a
CUDA tensor it launches its kernel or raises.

    python -m kmeans_tpu_torch.tools.exp_gather [--cpu]

prints one `{"form", "correct"}` line per placement, `{"working_forms"}`,
the ulps of `powf` against the table, and `{"lut_ms": {placement: ms},
"pow_ms": ms}`, each the median of CUDA-event timings (cold L2). It needs
a card; `--cpu` runs the twins, where no device time exists and the times
read "not measured".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops._math import div
from kmeans_tpu_torch.tools import _exp

ROWS, LANES = 128, 128
PLACEMENTS = ("shared", "constant", "global")
REPEAT = 8
# The 4K-sized grid: ceil(3840 * 2160 / 128) = 64,800 rows, rounded up to a
# multiple of ROWS.
GRID_ROWS = 64_896


def gamma_table_np() -> np.ndarray:
    """numpy's float32 `(i / 255) ** 2.4`, as the reference makes it."""
    return (np.arange(256, dtype=np.float32) / 255.0) ** 2.4


def gamma_table(device) -> torch.Tensor:
    """The table's float32 bits as a `[256]` tensor on `device`."""
    return torch.from_numpy(gamma_table_np()).to(device)


def gather_indices(seed: int = 3) -> np.ndarray:
    """`try_form`'s `[128, 128]` int32 indices in [0, 256)."""
    return np.random.default_rng(seed).integers(0, 256, (ROWS, LANES)).astype(np.int32)


def grid_indices(rng: np.random.Generator, rows: int = GRID_ROWS) -> np.ndarray:
    """The timed `[rows, 128]` int32 grid in [0, 256)."""
    return rng.integers(0, 256, (rows, LANES)).astype(np.int32)


def _check(idx: torch.Tensor, table: torch.Tensor | None = None) -> None:
    if idx.dtype != torch.int32 or idx.numel() < 1:
        raise ValueError(f"expected int32 indices, got {idx.dtype}")
    if table is not None and (table.dtype != torch.float32 or tuple(table.shape) != (256,)):
        raise ValueError(f"expected a [256] float32 table, got {tuple(table.shape)} "
                         f"{table.dtype}")


def gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The table's value at each `idx & 255`."""
    return table[(idx & 255).long()]


def lut_sum_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`sum_j table[(idx + j) & 255]`, j = 0..7 from 0, left to right."""
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for j in range(REPEAT):
        acc = acc + table[((idx + j) & 255).long()]
    return acc


def srgb_transfer(c: torch.Tensor) -> torch.Tensor:
    """The sRGB decoding curve on float32 `c` in [0, 1], true divides."""
    return torch.where(c > 0.04045, div(c + 0.055, 1.055) ** 2.4, div(c, 12.92))


def pow_sum_reference(idx: torch.Tensor) -> torch.Tensor:
    """`sum_j srgb_transfer(((idx + j) & 255) / 255)`, j = 0..7 from 0."""
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for j in range(REPEAT):
        acc = acc + srgb_transfer(div(((idx + j) & 255).to(torch.float32), 255.0))
    return acc


def pow_table_reference(device) -> torch.Tensor:
    """`(i / 255) ** 2.4` for i < 256 in torch float32, true divide."""
    return div(torch.arange(256, dtype=torch.float32, device=device), 255.0) ** 2.4


def _launch_lut(table, idx, placement: str, repeat: int) -> torch.Tensor:
    if idx.device.type != "cuda" or table.device != idx.device:
        raise ValueError(f"table and indices must be on one CUDA device, got {table.device} "
                         f"and {idx.device}")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    lib = _exp.load_exp_library()
    idx_c = idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = lib.exp_lut(idx_c.data_ptr(), table.contiguous().data_ptr(), out.data_ptr(),
                          idx.numel(), PLACEMENTS.index(placement), repeat,
                          _exp.stream_of(out))
    _exp.check(lib, err, "exp_lut")
    kernels.LAUNCHES_BY_MODE["exp_gather" if repeat == 1 else "exp_lut", placement,
                             "table"] += 1
    return out


def gather(table: torch.Tensor, idx: torch.Tensor, placement: str = "shared") -> torch.Tensor:
    """The table's value at each index, the table read from `placement`;
    see `gather_reference`. A CPU tensor runs the twin."""
    _check(idx, table)
    if idx.device.type == "cpu":
        return gather_reference(table, idx)
    return _launch_lut(table, idx, placement, 1)


def lut_sum(table: torch.Tensor, idx: torch.Tensor, placement: str = "shared") -> torch.Tensor:
    """The sum of 8 table reads per element; see `lut_sum_reference`. A CPU
    tensor runs the twin."""
    _check(idx, table)
    if idx.device.type == "cpu":
        return lut_sum_reference(table, idx)
    return _launch_lut(table, idx, placement, REPEAT)


def pow_sum(idx: torch.Tensor) -> torch.Tensor:
    """The sum of 8 sRGB transfers by `powf` per element; see
    `pow_sum_reference`. A CPU tensor runs the twin."""
    _check(idx)
    if idx.device.type == "cpu":
        return pow_sum_reference(idx)
    if idx.device.type != "cuda":
        raise ValueError(f"pow_sum runs on cpu or cuda, not {idx.device}")
    lib = _exp.load_exp_library()
    idx_c = idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = lib.exp_pow(idx_c.data_ptr(), out.data_ptr(), idx.numel(), _exp.stream_of(out))
    _exp.check(lib, err, "exp_pow")
    kernels.LAUNCHES_BY_MODE["exp_pow", "-", "powf"] += 1
    return out


def pow_table(device) -> torch.Tensor:
    """`powf(i / 255, 2.4)` for i < 256 on the card (the twin on the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return pow_table_reference(device)
    lib = _exp.load_exp_library()
    out = torch.empty(256, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.exp_pow_table(out.data_ptr(), _exp.stream_of(out))
    _exp.check(lib, err, "exp_pow_table")
    kernels.LAUNCHES_BY_MODE["exp_pow_table", "-", "powf"] += 1
    return out


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between float32 values of one sign."""
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return (ai - bi).abs()


def measure(device: torch.device, reps: int = 20) -> list[dict]:
    """The tool's lines on `device`. Each kernel runs once for its result
    (one launch on the card), then `reps` more times under CUDA events
    when `reps > 0` and there is a card."""
    timed = device.type == "cuda" and reps > 0
    table = gamma_table(device)
    idx = torch.from_numpy(gather_indices()).to(device)
    want = torch.from_numpy(gamma_table_np()[gather_indices()]).to(device)
    lines, working = [], []
    for placement in PLACEMENTS:
        ok = bool(torch.equal(gather(table, idx, placement).view(torch.int32),
                              want.view(torch.int32)))
        lines.append({"form": placement, "correct": ok})
        if ok:
            working.append(placement)
    lines.append({"working_forms": working})
    u = ulps(pow_table(device), table)
    lines.append({"pow_table_vs_numpy": {"entries_differing": int((u > 0).sum()),
                                         "max_ulps": int(u.max())}})
    grid = torch.from_numpy(grid_indices(np.random.default_rng(3))).to(device)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device) if timed else None
    runs = {p: (lambda p=p: lut_sum(table, grid, p)) for p in working}
    runs["pow"] = lambda: pow_sum(grid)
    times = {}
    for name, fn in runs.items():
        fn()
        times[name] = _exp.median_ms(fn, reps, flush) if timed else "not measured"
    lines.append({
        "elements": grid.numel(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "lut_ms": {p: times[p] for p in working},
        "pow_ms": times["pow"],
    })
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    args = parser.parse_args(argv)
    device = _exp.device_for(args.cpu, "exp_gather")
    if device.type == "cuda":
        print(json.dumps({"card": _exp.card_line()}), flush=True)
    for line in measure(device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
