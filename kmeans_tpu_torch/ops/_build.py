"""Build and load the port's CUDA kernels.

`load_library()` compiles `kmeans_tpu_torch/csrc/*.cu` with `nvcc` (one
process for each source, all started together) and links them into one
shared library with a plain C interface, caches it under
`build/kmeans_tpu_torch/` at the root of the checkout, and loads it with
`ctypes`. The file name carries a hash of the sources, the flags and the
compiler path, so an unchanged tree builds once. `nvcc` is taken from
`CUDA_HOME` (or `CUDA_PATH`), else from `PATH`, else from the toolkit's
default `/usr/local/cuda`. A failed build raises with the compiler's
output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kmeans_tpu_torch"

# --fmad=false: no FMA contraction anywhere in the library, so the kernel's
# float32 arithmetic rounds like plain PyTorch's one-op-per-launch math
# (the kernel source also spells each operation with an _rn intrinsic).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the last compile in this process took (None: nothing compiled).
last_build_seconds: float | None = None


def find_nvcc() -> str:
    """Path of `nvcc`, or raise if no CUDA toolkit is found."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME to the CUDA toolkit or put nvcc on PATH"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(nvcc: str) -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"kmeans_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library for them exists yet; return its
    path. Concurrent builds each work in a private directory and rename
    the library into place, so a reader never sees a partial one."""
    global last_build_seconds
    nvcc = find_nvcc()
    target = library_path(nvcc)
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{src.stem}.o") for src in _sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            for src, obj in zip(_sources(), objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, output in zip(compiles, procs, outputs):
            _check(cmd, proc.returncode, output)
        tmp = str(Path(work) / target.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        done = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _check(link, done.returncode, done.stdout)
        os.replace(tmp, target)
    last_build_seconds = time.perf_counter() - t0
    return target


def _check(cmd: list[str], returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{output}")


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' argument types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.kmeans_assign_packed.argtypes = [
            p, i64, i64,       # rgb, n, width
            p, i32, i32,       # centroids, kp, k_active
            p, p,              # gamma_lut, threshold
            i32, i64,          # dither, row_offset
            i32, i32,          # bits, tile_rows
            p, i64,            # out, n_words
            p,                 # stream
        ]
        lib.kmeans_assign_packed.restype = i32
        lib.kmeans_lloyd_grid_blocks.argtypes = [i64]
        lib.kmeans_lloyd_grid_blocks.restype = i32
        lib.kmeans_lloyd_accumulate.argtypes = [
            p, i32, i64, i64,  # planes, bf16, n_pix, n_valid
            p, i32, i32,       # centroids, kp, k_active
            p, i32,            # weight (or null), stats
            p, i32, p,         # partials, n_blocks, out
            p,                 # stream
        ]
        lib.kmeans_lloyd_accumulate.restype = i32
        lib.kmeans_error_string.argtypes = [i32]
        lib.kmeans_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
