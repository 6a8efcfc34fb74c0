"""Image file IO: PNG, and the JPEG and GIF entry points that need a native
codec.

Port of `kmeans_tpu/utils/imageio.py`, the reference CLI's decode and
encode. The reference dispatches to its native C runtime
(`kmeans_tpu/runtime/_imagio.c`: libpng, libjpeg, GIF89a) and falls back
to the pure-Python PNG codec when that extension is not built. The port
cannot import that extension (the import runs `kmeans_tpu/__init__.py`,
which imports JAX) and has no native codec of its own yet (ROADMAP), so
this module is the reference's fallback path: PNG goes through
`utils/png_py.py` (decode of every colour type; encode as 8-bit RGBA, the
bytes the reference writes without its extension), and JPEG and GIF raise
`RuntimeError` where the reference raises without it (`:83`, `:129`,
`:164`, `:196`). `HAVE_NATIVE` says so to callers, as the reference's does.
"""

from __future__ import annotations

import os

import numpy as np

from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils import png_py

HAVE_NATIVE = False


def set_max_decode_pixels(n: int) -> int:
    """Cap the total pixels any single decode may produce
    (kmeans_tpu/utils/imageio.py:30). Untrusted bytes can declare huge
    dimensions in tiny payloads; the cap refuses them before any
    allocation. Default 512 Mpix (2 GB RGBA). Returns the previous limit.
    Also settable by the KMEANS_TPU_MAX_DECODE_PIXELS environment variable,
    read when this module is imported."""
    return png_py.set_max_decode_pixels(int(n))


def get_max_decode_pixels() -> int:
    return png_py.max_decode_pixels()


_env_limit = os.environ.get("KMEANS_TPU_MAX_DECODE_PIXELS")
if _env_limit:
    try:
        set_max_decode_pixels(int(_env_limit))
    except ValueError as _e:
        raise ValueError(
            "KMEANS_TPU_MAX_DECODE_PIXELS must be a positive integer "
            f"(pixel count), got {_env_limit!r}"
        ) from _e


def _no_native(what: str) -> RuntimeError:
    return RuntimeError(f"{what} support requires the native runtime")


def load_image(path: str | os.PathLike) -> Image:
    """Decode a .png or .jpg/.jpeg file into an RGBA8 `Image`."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".png", ".jpg", ".jpeg"):
        raise ValueError("Only support png or jpg files.")
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_bytes(data)


def save_image(image: Image, path: str | os.PathLike, quality: int = 90) -> None:
    """Encode an RGBA8 `Image` to .png (or .jpg, which needs the native
    codec) by the extension. `quality` is the JPEG quality."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png_bytes(image)
    elif ext in (".jpg", ".jpeg"):
        raise _no_native("JPEG")
    else:
        raise ValueError("Only support png or jpg files.")
    with open(path, "wb") as f:
        f.write(data)


def decode_image_bytes(data: bytes) -> Image:
    """Decode in-memory PNG (or JPEG, which needs the native codec) bytes,
    the format sniffed from the magic number, into an RGBA8 `Image`."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        w, h, rgba = png_py.decode_png(data)
    elif data[:2] == b"\xff\xd8":
        raise _no_native("JPEG")
    else:
        raise ValueError("unrecognized image format (need PNG or JPEG)")
    pixels = np.frombuffer(rgba, np.uint8).reshape(h, w, 4)
    return Image((w, h), pixels)


def encode_png_bytes(image: Image) -> bytes:
    """Encode an RGBA8 `Image` to in-memory PNG bytes (8-bit RGBA)."""
    w, h = image.dimensions
    return png_py.encode_png(w, h, np.ascontiguousarray(image.pixels, dtype=np.uint8).tobytes())


def load_gif(path: str | os.PathLike, with_delays: bool = False):
    """Decode an animated GIF into full-canvas RGBA8 frames (and, with
    `with_delays`, each frame's delay in centiseconds): needs the native
    codec."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    return decode_gif_bytes(data, with_delays=with_delays)


def decode_gif_bytes(data: bytes, with_delays: bool = False):
    """In-memory variant of `load_gif`: needs the native codec."""
    raise _no_native("GIF")


def save_gif(frames: list[Image], path: str | os.PathLike, delay_cs: int = 100,
             loop: bool = True, delays: list[int] | None = None) -> None:
    """Encode quantized frames (each <= 256 colours) as an animated GIF:
    needs the native codec."""
    data = encode_gif_bytes(frames, delay_cs=delay_cs, loop=loop, delays=delays)
    with open(os.fspath(path), "wb") as f:
        f.write(data)


def encode_gif_bytes(frames: list[Image], delay_cs: int = 100, loop: bool = True,
                     delays: list[int] | None = None) -> bytes:
    """In-memory variant of `save_gif`: needs the native codec."""
    raise _no_native("GIF")
