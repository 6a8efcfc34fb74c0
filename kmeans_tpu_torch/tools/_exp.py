"""What the experiment tools share: their CUDA library, its launch
counts, and CUDA-event timing.

`load_exp_library()` builds `tools/csrc/*.cu` (which include `csrc/*.cuh`)
into `build/kmeans_tpu_torch/kmeans_tpu_torch_exp_<hash>.so` on first use,
apart from the main library, and declares its C entry points. Each
wrapper adds one to `ops.kernels.LAUNCHES_BY_MODE` under its own key where
it launches its kernel, as the main library's wrappers do.
"""

from __future__ import annotations

import ctypes
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
    lib.exp_lut.argtypes = [p, p, p, i64, i32, i32, p]  # idx, table, out, n, placement, repeat
    lib.exp_lut.restype = i32
    lib.exp_pow.argtypes = [p, p, i64, p]  # idx, out, n, stream
    lib.exp_pow.restype = i32
    lib.exp_pow_table.argtypes = [p, p]  # out, stream
    lib.exp_pow_table.restype = i32
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
