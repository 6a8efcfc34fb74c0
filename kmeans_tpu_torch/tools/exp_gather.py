"""Hardware experiment: a 256-entry table read against `powf`, by where the
table lives.

Port of `tools/exp_gather.py`. The reference asks which 2-D gather forms
its TPU compiler lowers; on Hopper the question is where a 256-entry
float32 table lives when every element reads it at a random index. One
kernel (`tools/csrc/exp_gather.cu`) reads it from each `PLACEMENTS` entry:

- `shared`: staged in shared memory by every block, as the port's kernels
  B1-B7 stage the gamma table.
- `constant`: `__constant__` memory, filled by a copy of its own
  (`fill_constant`) only when the table's bits may have changed, so a
  call with a resident table is one kernel. The constant cache serves one
  address a warp a pass, so every block reads it with one address a warp
  a read and serves the divergent reads from shared memory.
- `global`: device memory through the read-only cache (`__ldg`).

The sums of 8 reads of the shared and constant placements read a staged
layout (`staged_table`, `staged_word`): 32 copies interleaved word by word,
one a lane, so a warp's 32 reads hit 32 banks whatever the indices.

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
  0.04045, else `c / 12.92`, rounded as true divides and `powf` round it.
  The kernel computes the curve for its 256 possible inputs alone: divides
  by constants as two-float reciprocal products and `powf`'s own path
  without its checks (`tools/csrc/exp_gather.cu`). As in the reference, it
  computes another function than the table (the sRGB curve, not a plain
  2.4 power): only the two sums' times compare.

`pow_table` gives `powf(i / 255, 2.4)` for i < 256, to count its ulps
against the numpy table; `pow_probe` evaluates the kernel's own curve and
each of its divides on all 256 inputs, beside the first form's term by
`__fdiv_rn` and `powf`, and `probe_report` counts where they differ. On a
CPU tensor each wrapper runs its twin; on a CUDA tensor it launches its
kernel or raises.

    python -m kmeans_tpu_torch.tools.exp_gather [--cpu]

prints one `{"form", "correct"}` line per placement, `{"working_forms"}`,
the ulps of `powf` against the table, the curve probe's counts
(`{"pow_curve_probe": probe_report(...)}`), and `{"lut_ms": {placement:
ms}, "pow_ms": ms, "fill_ms": ms, "empty_ms": ms}`, each the median of
CUDA-event timings (cold L2): the constant placement's fill alone and an
empty kernel (the launch floor) beside the kernels. It needs
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
# The staged layout of `tools/csrc/exp_gather.cu` (`kSpan`, `kLutCopies`):
# entries 0..262, entry i holding table[i & 255], in 32 interleaved copies.
STAGED_SPAN = 256 + REPEAT - 1
LUT_COPIES = 32
# The rows of `pow_probe`, in the order `pow_probe_kernel` writes them.
PROBE_ROWS = ("curve", "c", "linear", "base", "powf")
# Where `probe_report` compares the curve's power in float64: at the
# exponent and divisor as float32 values.
POW_F32 = float(np.float32(2.4))
LINEAR_F32 = float(np.float32(12.92))


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


def _check_table(table: torch.Tensor) -> None:
    if table.dtype != torch.float32 or tuple(table.shape) != (256,):
        raise ValueError(f"expected a [256] float32 table, got {tuple(table.shape)} "
                         f"{table.dtype}")


def _check(idx: torch.Tensor, table: torch.Tensor | None = None) -> None:
    if idx.dtype != torch.int32 or idx.numel() < 1:
        raise ValueError(f"expected int32 indices, got {idx.dtype}")
    if table is not None:
        _check_table(table)


def gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The table's value at each `idx & 255`."""
    return table[(idx & 255).long()]


def lut_sum_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`sum_j table[(idx + j) & 255]`, j = 0..7 from 0, left to right."""
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for j in range(REPEAT):
        acc = acc + table[((idx + j) & 255).long()]
    return acc


def staged_table(table: torch.Tensor) -> torch.Tensor:
    """The kernel's staged table as `[STAGED_SPAN * LUT_COPIES]` words:
    word w holds entry `(w // LUT_COPIES) & 255`."""
    entries = torch.arange(STAGED_SPAN * LUT_COPIES, device=table.device) // LUT_COPIES
    return table[entries & 255]


def staged_word(x: torch.Tensor, j, lane) -> torch.Tensor:
    """The word of `staged_table` that lane `lane` (0..31) reads for the
    j-th term of index `x`: entry `(x & 255) + j` of copy `lane`, in bank
    `lane`."""
    return ((x & 255) + j) * LUT_COPIES + lane


def lut_sum_staged(table: torch.Tensor, idx: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """`lut_sum_reference` read as the staged kernels read: element e by
    lane `lanes[e]`, through `staged_word`."""
    words = staged_table(table)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for j in range(REPEAT):
        acc = acc + words[staged_word(idx.long(), j, lanes.long())]
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


def pow_probe_reference(device) -> dict[str, torch.Tensor]:
    """`pow_probe`'s rows by true divides and torch's `pow`, for i < 256."""
    c = div(torch.arange(256, dtype=torch.float32, device=device), 255.0)
    curve = srgb_transfer(c)
    return {"curve": curve, "c": c, "linear": div(c, 12.92), "base": div(c + 0.055, 1.055),
            "powf": curve}


def pow_table_reference(device) -> torch.Tensor:
    """`(i / 255) ** 2.4` for i < 256 in torch float32, true divide."""
    return div(torch.arange(256, dtype=torch.float32, device=device), 255.0) ** 2.4


def constant_key(table: torch.Tensor, stream: int, lib_handle: int) -> tuple | None:
    """What a fill of the constant placement from `table` on `stream` is
    known by: the library, the device, the stream, the table's address and
    its version counter, which every in-place write through PyTorch (on
    the tensor or on any view of it) advances. None for a tensor that keeps
    no version counter (made under `torch.inference_mode`): its bits can
    change unseen. Writes PyTorch does not see (through `.data`, or a raw
    pointer) are not seen here either."""
    try:
        version = table._version
    except RuntimeError:
        return None
    return (lib_handle, table.device.index, stream, table.data_ptr(), version)


def needs_fill(resident: tuple | None, key: tuple | None) -> bool:
    """Whether the constant placement must be filled before a call whose
    table has `key`, when the last fill had `resident`."""
    return key is None or key != resident


# The last fill of each (library, device): its key, and the table it came
# from, held so that its memory cannot pass to another tensor while the
# key stands.
_RESIDENT: dict[tuple[int, int | None], tuple[tuple | None, torch.Tensor]] = {}


def fill_constant(table: torch.Tensor, force: bool = True) -> bool:
    """Copy `table` (a contiguous `[256]` float32 CUDA tensor) into the
    constant placement's memory on the current stream: always, or with
    `force=False` only when `needs_fill` says so. Returns whether it
    copied; each copy adds one to its count."""
    _check_table(table)
    if table.device.type != "cuda" or not table.is_contiguous():
        raise ValueError(f"expected a contiguous CUDA table, got {table.device}")
    lib = _exp.load_exp_library()
    stream = _exp.stream_of(table)
    slot = (lib._handle, table.device.index)
    key = constant_key(table, stream, lib._handle)
    if not force and not needs_fill(_RESIDENT.get(slot, (None,))[0], key):
        return False
    with torch.cuda.device(table.device):
        err = lib.exp_lut_fill(table.data_ptr(), stream)
    _exp.check(lib, err, "exp_lut_fill")
    _RESIDENT[slot] = (key, table)
    kernels.LAUNCHES_BY_MODE["exp_lut_fill", "constant", "copy"] += 1
    return True


def _launch_lut(table, idx, placement: str, repeat: int) -> torch.Tensor:
    if idx.device.type != "cuda" or table.device != idx.device:
        raise ValueError(f"table and indices must be on one CUDA device, got {table.device} "
                         f"and {idx.device}")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    lib = _exp.load_exp_library()
    idx_c, table_c = idx.contiguous(), table.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        if placement == "constant":
            fill_constant(table_c, force=False)
        err = lib.exp_lut(idx_c.data_ptr(), table_c.data_ptr(), out.data_ptr(), idx.numel(),
                          PLACEMENTS.index(placement), repeat, _exp.sm_count(idx.device.index),
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
    """The sum of 8 evaluations of the sRGB curve per element; see
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
        err = lib.exp_pow(idx_c.data_ptr(), out.data_ptr(), idx.numel(),
                          _exp.sm_count(idx.device.index), _exp.stream_of(out))
    _exp.check(lib, err, "exp_pow")
    kernels.LAUNCHES_BY_MODE["exp_pow", "-", "curve"] += 1
    return out


def pow_probe(device) -> dict[str, torch.Tensor]:
    """The kernel's own curve on all 256 inputs, as `PROBE_ROWS`: the curve
    (what `pow_kernel` adds), its c = i / 255, its c / 12.92, its
    (c + 0.055) / 1.055, and the first form's term by `__fdiv_rn` and
    `powf`; `[256]` float32 each (the twin on the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return pow_probe_reference(device)
    lib = _exp.load_exp_library()
    out = torch.empty((len(PROBE_ROWS), 256), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.exp_pow_probe(out.data_ptr(), _exp.stream_of(out))
    _exp.check(lib, err, "exp_pow_probe")
    kernels.LAUNCHES_BY_MODE["exp_pow_probe", "-", "curve"] += 1
    return dict(zip(PROBE_ROWS, out))


def _differing(a: torch.Tensor, b: torch.Tensor) -> dict:
    u = ulps(a, b)
    return {"inputs": u.numel(), "entries_differing": int((u > 0).sum()),
            "max_ulps": int(u.max())}


def probe_report(rows: dict[str, torch.Tensor]) -> dict:
    """Where `pow_probe`'s rows differ, in entries and ulps: the curve
    against the first form's term (`powf`) and against the curve taken in
    float64 from the true float32 base (or c) and rounded once to float32;
    each divide against the true divide on the same device over the inputs
    the curve takes it on (i / 255 on 256, (c + 0.055) / 1.055 on the 245
    above the threshold, c / 12.92 on the 11 below)."""
    ref = pow_probe_reference(rows["c"].device)
    above = ref["c"] > 0.04045
    rounded = torch.where(above, ref["base"].double() ** POW_F32,
                          ref["c"].double() / LINEAR_F32).float()
    return {
        "curve_vs_powf": _differing(rows["curve"], rows["powf"]),
        "curve_vs_float64": _differing(rows["curve"], rounded),
        "divide_255": _differing(rows["c"], ref["c"]),
        "divide_1055": _differing(rows["base"][above], ref["base"][above]),
        "divide_1292": _differing(rows["linear"][~above], ref["linear"][~above]),
    }


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


def empty(device) -> None:
    """Launch a kernel that does nothing on `device`'s current stream:
    the launch floor the single read is held against."""
    device = torch.device(device)
    lib = _exp.load_exp_library()
    with torch.cuda.device(device):
        err = lib.exp_empty(torch.cuda.current_stream(device).cuda_stream)
    _exp.check(lib, err, "exp_empty")
    kernels.LAUNCHES_BY_MODE["exp_empty", "-", "floor"] += 1


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
    lines.append({"pow_curve_probe": probe_report(pow_probe(device))})
    grid = torch.from_numpy(grid_indices(np.random.default_rng(3))).to(device)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device) if timed else None
    runs = {p: (lambda p=p: lut_sum(table, grid, p)) for p in working}
    runs["pow"] = lambda: pow_sum(grid)
    times = {}
    for name, fn in runs.items():
        fn()
        times[name] = _exp.median_ms(fn, reps, flush) if timed else "not measured"
    # The constant placement's fill alone and the launch floor, timed only.
    for name, fn in (("fill", lambda: fill_constant(table)), ("empty", lambda: empty(device))):
        times[name] = _exp.median_ms(fn, reps, flush) if timed else "not measured"
    lines.append({
        "elements": grid.numel(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "lut_ms": {p: times[p] for p in working},
        "pow_ms": times["pow"],
        "fill_ms": times["fill"],
        "empty_ms": times["empty"],
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
