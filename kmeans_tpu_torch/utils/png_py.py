"""Pure-Python PNG codec (zlib, numpy): the port's PNG decoder and encoder.

A copy of `kmeans_tpu/utils/png_py.py`, kept inside the port because
importing `kmeans_tpu` imports JAX. It decodes 1/2/4/8/16-bit greyscale,
greyscale with alpha, RGB, RGBA and palette images with every tRNS form
and all five scanline filters (not interlaced), and encodes 8-bit RGBA,
filter 0, zlib level 6: the bytes the reference writes without its native
codec. The left-dependent filters (Sub, Average, Paeth) unfilter in a
per-byte Python loop, so a large image filtered that way decodes slowly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        yield ctype, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


_MAX_DECODE_PIXELS = 512 * 1024 * 1024  # the reference's default (its native codec's too)


def max_decode_pixels() -> int:
    return _MAX_DECODE_PIXELS


def set_max_decode_pixels(n: int) -> int:
    """Set the fallback decoder's pixel budget; returns the previous value.
    Normally driven through
    `kmeans_tpu_torch.utils.imageio.set_max_decode_pixels`."""
    global _MAX_DECODE_PIXELS
    n = int(n)
    if n <= 0:
        raise ValueError("limit must be positive")
    old = _MAX_DECODE_PIXELS
    _MAX_DECODE_PIXELS = n
    return old


def decode_png(data: bytes) -> tuple[int, int, bytes]:
    """PNG bytes -> (width, height, RGBA8 bytes)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")

    width = height = 0
    bit_depth = color_type = 0
    palette = None
    trns_raw = None
    idat = bytearray()

    for ctype, chunk in _chunks(data):
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _comp, _filt, interlace = (
                struct.unpack(">IIBBBBB", chunk)
            )
            if interlace:
                raise ValueError("interlaced PNG not supported by fallback codec")
            limit = max_decode_pixels()
            if width == 0 or height == 0 or width * height > limit:
                raise ValueError(
                    f"image dimensions {width}x{height} exceed the decode "
                    f"limit of {limit} pixels (see "
                    "kmeans_tpu_torch.utils.imageio.set_max_decode_pixels)"
                )
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns_raw = chunk
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break

    # tRNS per color type: palette alpha (type 3, u8 per entry) or a
    # color key (type 0: one u16 gray sample; type 2: three u16 samples).
    trns = None
    color_key = None
    color_key16 = None
    keyed16 = None
    if trns_raw is not None:
        if color_type == 3:
            trns = np.frombuffer(trns_raw, np.uint8)
        elif color_type in (0, 2):
            samples = struct.unpack(f">{len(trns_raw) // 2}H", trns_raw)
            if bit_depth == 16:
                color_key16 = tuple(samples)
                color_key = tuple(s >> 8 for s in samples)
            else:
                color_key16 = None
                maxv = (1 << bit_depth) - 1
                color_key = tuple(s * 255 // maxv for s in samples)

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    sample_bytes = 2 if bit_depth == 16 else 1
    raw = zlib.decompress(bytes(idat))

    if bit_depth in (1, 2, 4):
        bits_per_px = bit_depth * channels
        stride = (width * bits_per_px + 7) // 8
    else:
        stride = width * channels * sample_bytes
    bpp = max(1, channels * sample_bytes)  # filter distance in bytes

    # Unfilter.
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos : pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            cur = line.copy()
            for i in range(stride):
                left = int(cur[i - bpp]) if i >= bpp else 0
                up = int(prev[i])
                ul = int(prev[i - bpp]) if i >= bpp else 0
                cur[i] = (cur[i] + _paeth(left, up, ul)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur

    # Expand to per-pixel samples.
    if bit_depth in (1, 2, 4):
        bits = np.unpackbits(out, axis=1)
        per = bit_depth
        samples = bits[:, : width * channels * per].reshape(height, width * channels, per)
        weights = (1 << np.arange(per - 1, -1, -1)).astype(np.uint16)
        vals = (samples * weights).sum(axis=2)
        maxv = (1 << bit_depth) - 1
        if color_type == 3:
            px = vals.reshape(height, width, channels)
        else:
            px = (vals * 255 // maxv).reshape(height, width, channels).astype(np.uint8)
    elif bit_depth == 16:
        arr = out.reshape(height, width, channels, 2)
        if color_key is not None and color_type in (0, 2):
            # PNG color keys match the EXACT 16-bit sample; evaluate before
            # stripping to 8 bits.
            full = arr[..., 0].astype(np.uint16) << 8 | arr[..., 1]
            key16 = np.asarray(color_key16, np.uint16)
            keyed16 = (full == key16).all(axis=2)
        else:
            keyed16 = None
        px = arr[..., 0]  # high byte ~ value/257
    else:
        px = out.reshape(height, width, channels)

    # To RGBA.
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[..., 0].astype(np.int64)
        rgb = palette[idx]
        alpha = np.full((height, width, 1), 255, np.uint8)
        if trns is not None:
            a = np.full(palette.shape[0], 255, np.uint8)
            a[: len(trns)] = trns
            alpha = a[idx][..., None]
        rgba = np.concatenate([rgb, alpha], axis=2)
    elif color_type == 0:
        g = px[..., :1]
        alpha = np.full_like(g, 255)
        if keyed16 is not None:
            alpha = np.where(keyed16[..., None], 0, 255).astype(np.uint8)
        elif color_key is not None:
            alpha = np.where(g == color_key[0], 0, 255).astype(np.uint8)
        rgba = np.concatenate([g, g, g, alpha], axis=2)
    elif color_type == 4:
        g, a = px[..., :1], px[..., 1:2]
        rgba = np.concatenate([g, g, g, a], axis=2)
    elif color_type == 2:
        alpha = np.full((height, width, 1), 255, np.uint8)
        if keyed16 is not None:
            alpha = np.where(keyed16, 0, 255).astype(np.uint8)[..., None]
        elif color_key is not None:
            keyed = (px == np.asarray(color_key, px.dtype)).all(axis=2)
            alpha = np.where(keyed, 0, 255).astype(np.uint8)[..., None]
        rgba = np.concatenate([px, alpha], axis=2)
    else:  # 6
        rgba = px

    return width, height, rgba.astype(np.uint8).tobytes()


def encode_png(width: int, height: int, rgba: bytes) -> bytes:
    """RGBA8 bytes -> PNG bytes (8-bit RGBA, filter 0)."""
    arr = np.frombuffer(rgba, np.uint8).reshape(height, width * 4)
    scanlines = bytearray()
    for y in range(height):
        scanlines.append(0)
        scanlines.extend(arr[y].tobytes())
    compressed = zlib.compress(bytes(scanlines), 6)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (
        _SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )
