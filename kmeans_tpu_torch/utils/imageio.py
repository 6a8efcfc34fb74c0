"""Image file IO: PNG, JPEG and GIF.

Port of `kmeans_tpu/utils/imageio.py`, the reference CLI's decode and
encode, with the reference's native branches on the port's native runtime
(`kmeans_tpu_torch/runtime/`, its copy of `kmeans_tpu/runtime/_imagio.c`).
GIF always runs the runtime's core unit, which needs only a C compiler.
PNG and JPEG run its libpng / libjpeg unit where the host has those
libraries' headers (`runtime.codec_available()`: `HAVE_NATIVE`, as the
reference's is once its extension is built); elsewhere they take the
reference's own path without its extension: PNG through the pure-Python
codec (`utils/png_py.py`: every colour type decoded, 8-bit RGBA written)
and JPEG refused with `RuntimeError`. `png_py` stays the PNG decoder's
twin in the tests either way, and keeps its own copy of the decode budget,
which `set_max_decode_pixels` sets beside the runtime's, as the reference
does.
"""

from __future__ import annotations

import os

import numpy as np

from kmeans_tpu_torch import runtime as _imagio
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils import png_py


def __getattr__(name: str):
    # HAVE_NATIVE asks the host's compiler once, on first use, not at import.
    if name == "HAVE_NATIVE":
        return _imagio.codec_available()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _no_native(what: str) -> RuntimeError:
    return RuntimeError(f"{what} support requires the native runtime")


def set_max_decode_pixels(n: int) -> int:
    """Cap the total pixels any single decode may produce, summed over GIF
    frames (kmeans_tpu/utils/imageio.py:30). Untrusted bytes can declare
    huge dimensions in tiny payloads; the cap refuses them before any
    allocation. Default 512 Mpix (2 GB RGBA). Returns the previous limit.
    Also settable by the KMEANS_TPU_MAX_DECODE_PIXELS environment variable,
    read when this module is imported."""
    n = int(n)
    png_py.set_max_decode_pixels(n)
    return _imagio.set_max_decode_pixels(n)


def get_max_decode_pixels() -> int:
    return _imagio.get_max_decode_pixels()


_env_limit = os.environ.get("KMEANS_TPU_MAX_DECODE_PIXELS")
if _env_limit:
    try:
        set_max_decode_pixels(int(_env_limit))
    except ValueError as _e:
        raise ValueError(
            "KMEANS_TPU_MAX_DECODE_PIXELS must be a positive integer "
            f"(pixel count), got {_env_limit!r}"
        ) from _e


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
    """Encode an RGBA8 `Image` to .png or .jpg by the extension
    (kmeans_tpu/utils/imageio.py:71); `quality` is the JPEG quality."""
    path = os.fspath(path)
    w, h = image.dimensions
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png_bytes(image)
    elif ext in (".jpg", ".jpeg"):
        if not _imagio.codec_available():
            raise _no_native("JPEG")
        rgba = np.ascontiguousarray(image.pixels, dtype=np.uint8)
        data = _imagio.encode_jpeg(w, h, rgba, quality)
    else:
        raise ValueError("Only support png or jpg files.")
    with open(path, "wb") as f:
        f.write(data)


def _encode_png_auto(image: Image) -> bytes:
    """Quantized outputs (<= 256 unique colours) encode as palette PNGs, 1
    byte a pixel, faster to deflate and smaller than RGBA
    (kmeans_tpu/utils/imageio.py:92). The palette is seeded from a sample
    (a full unique() with inverse over megapixels costs seconds) and
    extended with any colours the sample missed."""
    w, h = image.dimensions
    pixels = np.ascontiguousarray(image.pixels, dtype=np.uint8)
    packed = pixels.reshape(-1, 4).view(np.uint32).reshape(-1)
    colors = np.unique(packed[:: max(1, packed.size // 4096)])
    if len(colors) <= 256:
        for _ in range(2):
            idx = np.searchsorted(colors, packed)
            idx_c = np.minimum(idx, len(colors) - 1)
            miss = colors[idx_c] != packed
            if not miss.any():
                pal_rgba = colors.view(np.uint8).reshape(-1, 4)
                return _imagio.encode_png_indexed(w, h, pal_rgba, idx_c.astype(np.uint8))
            colors = np.union1d(colors, np.unique(packed[miss]))
            if len(colors) > 256:
                break
    return _imagio.encode_png(w, h, pixels)


def decode_image_bytes(data: bytes) -> Image:
    """Decode in-memory PNG or JPEG bytes (format sniffed from the magic
    number) into an RGBA8 `Image`: the serving path's entry, which never
    touches the filesystem."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        if _imagio.codec_available():
            w, h, rgba = _imagio.decode_png(data)
        else:
            w, h, rgba = png_py.decode_png(data)
    elif data[:2] == b"\xff\xd8":
        if not _imagio.codec_available():
            raise _no_native("JPEG")
        w, h, rgba = _imagio.decode_jpeg(data)
    else:
        raise ValueError("unrecognized image format (need PNG or JPEG)")
    pixels = np.frombuffer(rgba, np.uint8).reshape(h, w, 4)
    return Image((w, h), pixels)


def encode_png_bytes(image: Image) -> bytes:
    """Encode an RGBA8 `Image` to in-memory PNG bytes (indexed when the
    image has <= 256 colours, like `save_image`; 8-bit RGBA through
    `png_py` without the native PNG unit)."""
    if _imagio.codec_available():
        return _encode_png_auto(image)
    w, h = image.dimensions
    return png_py.encode_png(w, h, np.ascontiguousarray(image.pixels, dtype=np.uint8).tobytes())


def load_gif(path: str | os.PathLike, with_delays: bool = False):
    """Decode an animated GIF into full-canvas RGBA8 frames (disposal and
    transparency composited by the native decoder); with `with_delays`
    also each frame's delay in centiseconds."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    return decode_gif_bytes(data, with_delays=with_delays)


def decode_gif_bytes(data: bytes, with_delays: bool = False):
    """In-memory variant of `load_gif` (the serving path)."""
    w, h, frames, delays = _imagio.decode_gif(data)
    images = [Image((w, h), np.frombuffer(buf, np.uint8).reshape(h, w, 4)) for buf in frames]
    return (images, list(delays)) if with_delays else images


def save_gif(frames: list[Image], path: str | os.PathLike, delay_cs: int = 100,
             loop: bool = True, delays: list[int] | None = None) -> None:
    """Encode already-quantized frames (each <= 256 unique colours) as an
    animated GIF. `delays` (centiseconds, one per frame) overrides the
    uniform `delay_cs`."""
    data = encode_gif_bytes(frames, delay_cs=delay_cs, loop=loop, delays=delays)
    with open(os.fspath(path), "wb") as f:
        f.write(data)


def encode_gif_bytes(frames: list[Image], delay_cs: int = 100, loop: bool = True,
                     delays: list[int] | None = None) -> bytes:
    """In-memory variant of `save_gif` (the serving path): each frame's
    colours, sorted as packed RGB, become its local palette
    (kmeans_tpu/utils/imageio.py:192)."""
    if not frames:
        raise ValueError("need at least one frame")
    if delays is not None and len(delays) != len(frames):
        raise ValueError("delays must have one entry per frame")
    w, h = frames[0].dimensions
    payload = []
    for fi, frame in enumerate(frames):
        if frame.dimensions != (w, h):
            raise ValueError("all frames must share dimensions")
        rgb = frame.pixels[..., :3].astype(np.uint32)
        packed = ((rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]).reshape(-1)
        colors_packed, indices = np.unique(packed, return_inverse=True)
        if len(colors_packed) > 256:
            raise ValueError(
                f"frame has {len(colors_packed)} unique colors; quantize to <=256 first"
            )
        colors = np.stack(
            [(colors_packed >> 16) & 0xFF, (colors_packed >> 8) & 0xFF, colors_packed & 0xFF],
            axis=1,
        )
        entry = (colors.astype(np.uint8), indices.astype(np.uint8))
        if delays is not None:
            entry = entry + (int(delays[fi]),)
        payload.append(entry)
    return _imagio.encode_gif(w, h, payload, delay_cs, loop)
