"""The port's native host runtime: readback unpacks, the alpha strip, and
the PNG, JPEG and GIF codec.

The port's copy of `kmeans_tpu/runtime/_imagio.c` with a plain C
interface, in two units:

- `_imagio.c`: the decode budget, the GIF89a codec, the unpacks of the
  assign and meld kernels' words and the alpha strip. It needs only a C
  compiler, and every entry point of the port's main path runs it;
- `_imagio_codec.c`: PNG and JPEG through libpng and libjpeg, linked as
  the reference's `setup.py` links its extension. It builds where the
  compiler finds `png.h` and `jpeglib.h` (`codec_available()`); where it
  does not, `utils/imageio.py` takes the reference's own path without its
  extension (PNG through `utils/png_py.py`, JPEG refused).

Each unit is compiled at first use with the host's C compiler (`cc`),
cached as `build/kmeans_tpu_torch/<unit>_<hash>.so` beside the kernels'
library (the hash covers the unit's source, `_imagio.h`, the flags and the
compiler's path and version), and loaded with `ctypes`, which releases the interpreter
lock around each call: the server's handler threads and
`reduce_pipelined`'s unpack thread run the codec and the unpacks side by
side. A failed build raises with the compiler's output. Nothing here runs
at import time.

The functions below keep the signatures and results of the reference
extension's methods (`_imagio.c:1368-1398`), raising `ValueError` with its
texts for bad data; the unpacks and the strip return numpy arrays that
they write (into `out=` when the caller passes one, as a band's rows of
the host output), so the result is writable.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
HEADER = _DIR / "_imagio.h"
# unit -> (source, libraries); the reference's setup.py links png, jpeg, z.
UNITS = {
    "imagio": (_DIR / "_imagio.c", ()),
    "imagio_codec": (_DIR / "_imagio_codec.c", ("-lpng", "-ljpeg", "-lz")),
}
CFLAGS = ("-O2", "-fPIC", "-shared")  # the reference's extra_compile_args=["-O2"]
DEFAULT_MAX_DECODE_PIXELS = 512 * 1024 * 1024

_EVALUE, _ENOMEM = 1, 2
_ERRLEN = 512

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# The decode budget as last set; each library takes it when it loads.
_max_decode_pixels = DEFAULT_MAX_DECODE_PIXELS


def _build_dir() -> Path:
    from kmeans_tpu_torch.ops._build import BUILD_DIR

    return BUILD_DIR


def find_cc() -> str:
    """Path of the host C compiler, or raise."""
    found = shutil.which("cc")
    if not found:
        raise RuntimeError("no C compiler (cc) on PATH: the native runtime cannot be built")
    return found


def library_path(cc: str, unit: str = "imagio") -> Path:
    """Where `unit` built from its current source by `cc` lives. The name
    covers the compiler's version too: a library another host's compiler
    built, in a copied tree, is not taken for this host's."""
    source, libs = UNITS[unit]
    h = hashlib.sha256(source.read_bytes() + HEADER.read_bytes())
    h.update(" ".join(CFLAGS + libs).encode())
    version = subprocess.run([cc, "--version"], capture_output=True, text=True).stdout
    h.update(f"{cc}\n{version}".encode())
    return _build_dir() / f"{unit}_{h.hexdigest()[:16]}.so"


def build(unit: str = "imagio") -> Path:
    """Compile `unit` if no library for its current source exists yet;
    return its path. Each build works in a private directory and renames
    the library into place, so concurrent builds never expose a partial
    one."""
    cc = find_cc()
    target = library_path(cc, unit)
    if target.is_file():
        return target
    source, libs = UNITS[unit]
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as work:
        tmp = str(Path(work) / target.name)
        cmd = [cc, *CFLAGS, "-o", tmp, str(source), *libs]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(
                f"building the native runtime failed ({done.returncode}): "
                f"{' '.join(cmd)}\n{done.stdout}")
        os.replace(tmp, target)
    return target


@functools.cache
def codec_available() -> bool:
    """Whether the host's compiler finds libpng's and libjpeg's headers, so
    that the PNG and JPEG unit builds here (asked once a process)."""
    probe = subprocess.run(
        [find_cc(), "-E", "-x", "c", "-", "-o", os.devnull],
        input="#include <stdio.h>\n#include <png.h>\n#include <jpeglib.h>\n",
        capture_output=True, text=True)
    return probe.returncode == 0


def _declare(lib: ctypes.CDLL, unit: str) -> None:
    p, sz, u32, i32, u64 = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32, ctypes.c_int,
                            ctypes.c_uint64)
    pp, psz, pu32 = ctypes.POINTER(p), ctypes.POINTER(sz), ctypes.POINTER(u32)
    err = [ctypes.c_char_p, sz]
    lib.imagio_free.argtypes = [p]
    lib.imagio_free.restype = None
    lib.imagio_set_max_decode_pixels.argtypes = [u64, ctypes.POINTER(u64), *err]
    lib.imagio_set_max_decode_pixels.restype = i32
    if unit == "imagio_codec":
        for name in ("imagio_decode_png", "imagio_decode_jpeg"):
            getattr(lib, name).argtypes = [p, sz, pu32, pu32, pp, *err]
        lib.imagio_encode_png.argtypes = [u32, u32, p, sz, pp, psz, *err]
        lib.imagio_encode_png_indexed.argtypes = [u32, u32, p, sz, p, sz, pp, psz, *err]
        lib.imagio_encode_jpeg.argtypes = [u32, u32, p, sz, i32, pp, psz, *err]
        names = ("decode_png", "decode_jpeg", "encode_png", "encode_png_indexed",
                 "encode_jpeg")
    else:
        lib.imagio_encode_gif.argtypes = [u32, u32, i32, p, p, p, p, p, i32, pp, psz, *err]
        lib.imagio_decode_gif.argtypes = [p, sz, pu32, pu32, ctypes.POINTER(i32), pp, pp, *err]
        lib.imagio_unpack_rgb24.argtypes = [p, sz, u32, u32, u32, u32, p, sz, *err]
        lib.imagio_unpack_indices_gather.argtypes = [p, sz, u32, u32, u32, u32, u32, p, sz, p,
                                                     sz, *err]
        lib.imagio_strip_alpha.argtypes = [p, sz, p, sz, *err]
        names = ("encode_gif", "decode_gif", "unpack_rgb24", "unpack_indices_gather",
                 "strip_alpha")
    for name in names:
        getattr(lib, f"imagio_{name}").restype = i32


def _set_budget(lib: ctypes.CDLL, n: int) -> None:
    _call(lib.imagio_set_max_decode_pixels, n, ctypes.byref(ctypes.c_uint64()))


def load(unit: str = "imagio") -> ctypes.CDLL:
    """`unit`, built if needed and loaded once per process."""
    with _lock:
        if unit not in _libs:
            lib = ctypes.CDLL(str(build(unit)))
            _declare(lib, unit)
            _set_budget(lib, _max_decode_pixels)
            _libs[unit] = lib
        return _libs[unit]


def load_codec() -> ctypes.CDLL:
    """The PNG and JPEG unit (raises where it cannot build)."""
    return load("imagio_codec")


def _call(fn, *args) -> None:
    """Call a runtime entry point; raise its error as the reference does."""
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = fn(*args, err, _ERRLEN)
    if rc == _EVALUE:
        raise ValueError(err.value.decode())
    if rc == _ENOMEM:
        raise MemoryError(err.value.decode())
    if rc:
        raise RuntimeError(f"native runtime error {rc}: {err.value.decode()}")


def _u8(buf) -> np.ndarray:
    """A contiguous uint8 view of a bytes-like object or array (no copy
    where there is nothing to make contiguous)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


def _u32(value) -> int:
    value = int(value)
    if not 0 <= value < 1 << 32:
        raise OverflowError(f"{value} does not fit an unsigned 32-bit int")
    return value


def _take(lib: ctypes.CDLL, ptr, size: int) -> bytes:
    """Copy `size` bytes of a buffer `lib` allocated, and free it."""
    try:
        return ctypes.string_at(ptr, size)
    finally:
        lib.imagio_free(ptr)


def set_max_decode_pixels(n: int) -> int:
    """Cap the total pixels one decode may produce (summed over GIF
    frames), in every unit; returns the previous cap (`_imagio.c:1345`)."""
    global _max_decode_pixels
    n = int(n)
    if n <= 0:
        raise ValueError("limit must be positive")
    with _lock:
        old, _max_decode_pixels = _max_decode_pixels, n
        for lib in _libs.values():
            _set_budget(lib, n)
    return old


def get_max_decode_pixels() -> int:
    """The current decode cap (`_imagio.c:1360`)."""
    return _max_decode_pixels


def _decode(name: str, data) -> tuple[int, int, bytes]:
    lib = load_codec()
    src = _u8(data)
    w, h, out = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_void_p()
    _call(getattr(lib, name), src.ctypes.data, src.size, ctypes.byref(w), ctypes.byref(h),
          ctypes.byref(out))
    return w.value, h.value, _take(lib, out, w.value * h.value * 4)


def _encoded(lib: ctypes.CDLL, name: str, *args) -> bytes:
    out, size = ctypes.c_void_p(), ctypes.c_size_t()
    _call(getattr(lib, name), *args, ctypes.byref(out), ctypes.byref(size))
    return _take(lib, out, size.value)


def decode_png(data) -> tuple[int, int, bytes]:
    """PNG bytes -> `(width, height, rgba_bytes)`, every colour type and bit
    depth normalized to 8-bit RGBA (`_imagio.c:119`)."""
    return _decode("imagio_decode_png", data)


def encode_png(width: int, height: int, rgba) -> bytes:
    """8-bit RGBA PNG of `width * height * 4` bytes (`_imagio.c:193`)."""
    lib, src = load_codec(), _u8(rgba)
    return _encoded(lib, "imagio_encode_png", _u32(width), _u32(height),
                    src.ctypes.data, src.size)


def encode_png_indexed(width: int, height: int, palette, indices) -> bytes:
    """Palette PNG: `palette` is `<= 256` RGBA rows, `indices` one byte a
    pixel (`_imagio.c:251`)."""
    lib, pal, idx = load_codec(), _u8(palette), _u8(indices)
    return _encoded(lib, "imagio_encode_png_indexed", _u32(width),
                    _u32(height), pal.ctypes.data, pal.size, idx.ctypes.data, idx.size)


def decode_jpeg(data) -> tuple[int, int, bytes]:
    """JPEG bytes -> `(width, height, rgba_bytes)`, alpha 255
    (`_imagio.c:359`)."""
    return _decode("imagio_decode_jpeg", data)


def encode_jpeg(width: int, height: int, rgba, quality: int = 90) -> bytes:
    """Baseline JPEG of the RGB channels at `quality` (`_imagio.c:424`)."""
    lib, src = load_codec(), _u8(rgba)
    return _encoded(lib, "imagio_encode_jpeg", _u32(width),
                    _u32(height), src.ctypes.data, src.size, int(quality))


def encode_gif(width: int, height: int, frames: list, delay_cs: int = 100,
               loop: bool = True) -> bytes:
    """Animated GIF89a of `frames`, each `(rgb_palette, indices[, delay_cs])`
    with `<= 256` palette entries and one index byte a pixel
    (`_imagio.c:623`)."""
    if not isinstance(frames, list) or not frames:
        raise ValueError("frames must be a non-empty list")
    views, delays = [], []
    for frame in frames:
        pal, idx, *rest = frame
        views.append((_u8(pal), _u8(idx)))
        delays.append(int(rest[0]) if rest else int(delay_cs))
    n = len(frames)
    pals = (ctypes.c_void_p * n)(*[p.ctypes.data for p, _ in views])
    pal_lens = (ctypes.c_size_t * n)(*[p.size for p, _ in views])
    idxs = (ctypes.c_void_p * n)(*[i.ctypes.data for _, i in views])
    idx_lens = (ctypes.c_size_t * n)(*[i.size for _, i in views])
    lib = load()
    return _encoded(lib, "imagio_encode_gif", _u32(width), _u32(height), n,
                    pals, pal_lens, idxs, idx_lens, (ctypes.c_int32 * n)(*delays),
                    int(bool(loop)))


def decode_gif(data) -> tuple[int, int, list, list]:
    """GIF bytes -> `(width, height, [rgba_bytes, ...], [delay_cs, ...])`:
    full-canvas frames with disposal and transparency composited
    (`_imagio.c:880`)."""
    lib = load()
    src = _u8(data)
    w, h, n = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_int()
    frames, delays = ctypes.c_void_p(), ctypes.c_void_p()
    _call(lib.imagio_decode_gif, src.ctypes.data, src.size, ctypes.byref(w), ctypes.byref(h),
          ctypes.byref(n), ctypes.byref(frames), ctypes.byref(delays))
    size = w.value * h.value * 4
    try:
        out = [ctypes.string_at(frames.value + i * size, size) for i in range(n.value)]
        cs = list(ctypes.cast(delays, ctypes.POINTER(ctypes.c_int32))[:n.value])
    finally:
        lib.imagio_free(frames)
        lib.imagio_free(delays)
    return w.value, h.value, out, cs


def _output(out, n_bytes: int, shape: tuple) -> np.ndarray:
    """The array an unpack or strip writes: `out` (a writable C-contiguous
    uint8 array of at least `n_bytes`) or a new one."""
    if out is None:
        return np.empty(shape, np.uint8)
    if out.dtype != np.uint8 or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out must be a writable C-contiguous uint8 array")
    if out.size < n_bytes:
        raise ValueError(f"out holds {out.size} bytes, {n_bytes} needed")
    return out.reshape(-1)[:n_bytes].reshape(shape)


def unpack_rgb24(words, h: int, w: int, tile_rows: int, lanes: int, out=None) -> np.ndarray:
    """`[h, w, 4]` RGBA8 (alpha 255) from the meld kernel's RGB24 tile words
    (`_imagio.c:1109`); `utils/packing.py::_unpack_rgb24_np` is its numpy
    twin."""
    src = _u8(words)
    dst = _output(out, h * w * 4, (h, w, 4))
    _call(load().imagio_unpack_rgb24, src.ctypes.data, src.size, _u32(h), _u32(w),
          _u32(tile_rows), _u32(lanes), dst.ctypes.data, dst.size)
    return dst


def unpack_indices_gather(words, h: int, w: int, bits: int, tile_rows: int, lanes: int,
                          palette, out=None) -> np.ndarray:
    """`[h, w, 4]` RGBA8: the assign kernel's packed index words unpacked
    and each index's `[K, 4]` palette row gathered, in one pass
    (`_imagio.c:1211`); an index past the palette raises `ValueError`."""
    src = _u8(words)
    if src.ctypes.data % 4:  # read as 32-bit words
        src = src.copy()
    pal = _u8(np.asarray(palette, dtype=np.uint8))
    dst = _output(out, h * w * 4, (h, w, 4))
    _call(load().imagio_unpack_indices_gather, src.ctypes.data, src.size, _u32(h), _u32(w),
          _u32(bits), _u32(tile_rows), _u32(lanes), pal.ctypes.data, pal.size,
          dst.ctypes.data, dst.size)
    return dst


def strip_alpha(rgba: np.ndarray, out=None) -> np.ndarray:
    """`[..., 4]` uint8 -> `[..., 3]`: the RGB bytes of each pixel
    (`_imagio.c:1310`)."""
    src = _u8(rgba)
    shape = rgba.shape[:-1] + (3,)
    dst = _output(out, src.size // 4 * 3, shape)
    _call(load().imagio_strip_alpha, src.ctypes.data, src.size, dst.ctypes.data, dst.size)
    return dst
