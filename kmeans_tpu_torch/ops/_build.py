"""Build and load the port's CUDA kernels.

`load_library()` compiles `kmeans_tpu_torch/csrc/*.cu` with `nvcc` (one
process for each source, all started together) and links them into one
shared library with a plain C interface, caches it under
`build/kmeans_tpu_torch/` at the root of the checkout, and loads it with
`ctypes`. `load(src_dir, name, declare)` does the same for another source
directory: the experiment tools build `kmeans_tpu_torch/tools/csrc/*.cu`
into a second library, `kmeans_tpu_torch_exp_<hash>.so`, on their first
use, so the main library's build does not grow. Every compile sees
`csrc/` on its include path. The file name carries a hash of the sources,
the headers they may include (the source directory's `*.cuh` and
`csrc/*.cuh`), the flags and the compiler path, so an unchanged tree
builds once and an edited header builds anew. `nvcc` is taken from
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
EXP_CSRC = _PKG / "tools" / "csrc"
MAIN_NAME = "kmeans_tpu_torch"
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
_libs: dict[str, ctypes.CDLL] = {}


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


def _sources(src_dir: Path | None = None) -> list[Path]:
    """The files compiled, one `nvcc` process each (default: `CSRC`)."""
    return sorted((CSRC if src_dir is None else src_dir).glob("*.cu"))


def _hashed_files(src_dir: Path | None = None, include: Path | None = None) -> list[Path]:
    """The sources and the headers they may include."""
    src_dir = CSRC if src_dir is None else src_dir
    headers = set(src_dir.glob("*.cuh")) | set((include or CSRC).glob("*.cuh"))
    return _sources(src_dir) + sorted(headers)


def library_path(nvcc: str, src_dir: Path | None = None, name: str = MAIN_NAME,
                 include: Path | None = None) -> Path:
    """Where the library `name` for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _hashed_files(src_dir, include):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(src_dir: Path | None = None, name: str = MAIN_NAME,
          include: Path | None = None) -> Path:
    """Compile the sources of `src_dir` (default: `CSRC`) if no library
    for them exists yet; return its path. `include` (default: `CSRC`) is
    the header directory on the include path (another checkout's, to build
    its tools against its own headers). Concurrent builds each work in a
    private directory and rename the library into place, so a reader never
    sees a partial one."""
    nvcc = find_nvcc()
    target = library_path(nvcc, src_dir, name, include)
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = _sources(src_dir)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{src.stem}.o") for src in sources]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-I", str(include or CSRC), "-c", "-o", obj, str(src)]
            for src, obj in zip(sources, objs)
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
    return target


def _check(cmd: list[str], returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{output}")


def load(src_dir: Path, name: str, declare) -> ctypes.CDLL:
    """Build the library `name` from `src_dir` if needed, load it once per
    process, and let `declare(lib)` set its C entry points' argument
    types."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(src_dir, name)))
            declare(lib)
            _libs[name] = lib
        return _libs[name]


def load_library() -> ctypes.CDLL:
    """The main library (`csrc/`), built if needed and loaded once."""
    return load(CSRC, MAIN_NAME, _declare_main)


def _declare_main(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kmeans_assign.argtypes = [
        p, i64, i64, i64,  # rgb, n, width, frame_stride
        i32, p, i32,       # frames, centroids, kp
        i32, p, i32,       # k_active, k_actives (or null), chunk
        i32, i32, p, i32,  # metric, tier, gtab (or null), prune_m
        p, p, p,           # palette (or null), gamma_lut, thresholds
        i32, i64,          # dither, row_offset
        i32, i32, i32,     # out_mode, bits, tile_rows
        p, i64,            # out, n_words
        p,                 # stream
    ]
    lib.kmeans_assign.restype = i32
    lib.kmeans_meld.argtypes = [
        p, i64, i64, i32,  # rgb, n, frame_stride, frames
        p, i32,            # centroids, kp
        i32, p, i32,       # k_active, k_actives (or null), chunk
        i32, i32, p, i32,  # metric, tier, gtab (or null), prune_m
        p, i32,            # gamma_lut, tile_rows
        p, i64,            # out, n_groups
        p,                 # stream
    ]
    lib.kmeans_meld.restype = i32
    lib.kmeans_lloyd_grid_blocks.argtypes = [i64]
    lib.kmeans_lloyd_grid_blocks.restype = i32
    lib.kmeans_lloyd_accumulate.argtypes = [
        p, i32, i64, i64,  # planes, bf16, n_pix, n_valid
        p, i32, i32, i32,  # centroids, kp, k_active, metric
        i32, p, i32,       # tier, gtab (or null), prune_m
        p, i32,            # weight (or null), stats
        p, i32, p,         # partials, n_blocks, out
        p,                 # stream
    ]
    lib.kmeans_lloyd_accumulate.restype = i32
    lib.kmeans_dither_threshold.argtypes = [
        p, i32, i32,       # palettes, frames, kp
        i32, p, i32,       # k_active, k_actives (or null), metric
        p, p,              # out, stream
    ]
    lib.kmeans_dither_threshold.restype = i32
    lib.kmeans_srgb8_steps.argtypes = [p, p, p]  # steps, counts, stream
    lib.kmeans_srgb8_steps.restype = i32
    lib.kmeans_error_string.argtypes = [i32]
    lib.kmeans_error_string.restype = ctypes.c_char_p
