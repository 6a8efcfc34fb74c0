"""What the experiment tools share: their CUDA library, its launch
counts, CUDA-event timing and the device operations of a call.

`load_exp_library()` builds `tools/csrc/*.cu` (which include `csrc/*.cuh`)
into `build/kmeans_tpu_torch/kmeans_tpu_torch_exp_<hash>.so` on first use,
apart from the main library, and declares its C entry points. Each
wrapper adds one to `ops.kernels.LAUNCHES_BY_MODE` under its own key where
it launches its kernel, as the main library's wrappers do.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess

import torch

from kmeans_tpu_torch.ops import _build

EXP_NAME = "kmeans_tpu_torch_exp"


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.exp_factor_vpu.argtypes = [p, i64, p, i32, p, p, p]  # rgba, n, gtab, kp, lut, out, stream
    lib.exp_factor_vpu.restype = i32
    lib.exp_factor_mxu.argtypes = [p, i64, p, i32, i32, p, p, p]  # ..., gmat, kp, kp_pad, ...
    lib.exp_factor_mxu.restype = i32
    # idx, table, out, n, placement, repeat, sms, stream
    lib.exp_lut.argtypes = [p, p, p, i64, i32, i32, i32, p]
    lib.exp_lut.restype = i32
    lib.exp_lut_fill.argtypes = [p, p]  # table, stream
    lib.exp_lut_fill.restype = i32
    lib.exp_pow.argtypes = [p, p, i64, i32, p]  # idx, out, n, sms, stream
    lib.exp_pow.restype = i32
    lib.exp_empty.argtypes = [p]  # stream
    lib.exp_empty.restype = i32
    lib.exp_pow_table.argtypes = [p, p]  # out, stream
    lib.exp_pow_table.restype = i32
    lib.exp_pow_probe.argtypes = [p, p]  # out [5, 256], stream
    lib.exp_pow_probe.restype = i32
    lib.exp_error_string.argtypes = [i32]
    lib.exp_error_string.restype = ctypes.c_char_p


def build_exp_library():
    """Compile the experiment library if needed; return its path."""
    return _build.build(_build.EXP_CSRC, EXP_NAME)


def load_exp_library() -> ctypes.CDLL:
    """The experiment library, built if needed and loaded once."""
    return _build.load(_build.EXP_CSRC, EXP_NAME, _declare)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.exp_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`, asked once a process."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def median_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median milliseconds of `reps` calls of `fn` on the current stream,
    after one warm-up call, by CUDA events. With `flush` (a tensor larger
    than the L2 cache), it is overwritten before each call, outside the
    timed span, so each call starts with a cold cache."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ops(fn, calls: int = 1) -> list[str]:
    """The device operations (kernels, copies, sets) that `calls` calls of
    `fn` run, by name in order, from `torch.profiler`'s CUDA trace, after
    one call outside it. An empty list may also mean the trace saw no
    device activity at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA]


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_for(cpu: bool, tool: str) -> torch.device:
    """The CPU when asked for, else the card; raise when there is none."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} runs on a CUDA card; pass --cpu to run the plain twins")
    return torch.device("cuda", 0)
