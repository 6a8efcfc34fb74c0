"""PyTorch port vs the JAX package: file IO and the small API leftovers.

`kmeans_tpu_torch/utils/png_py.py` and `utils/imageio.py` against the
reference's `kmeans_tpu/utils/png_py.py` and `utils/imageio.py` (the
reference with its native runtime built for these tests and injected,
`_torch_reference_runtime.py`, where the port's native codec is compared):
the decode of every PNG colour type and bit depth, with and without tRNS,
every row through one of the five scanline filters, gives the same RGBA
bytes; the encode gives the same PNG bytes; the decode-pixel cap (set by
call and by the environment variable at import) refuses dimension bombs;
JPEG and GIF go through the native codec in both packages with the same
bytes (`tests/test_torch_codec.py` has the codec's own cases). Then
`copied_pixel` / `borrowed_pixel` and the tracing helpers `trace`,
`annotate` and `Timer` of `utils/profiling.py`.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import kmeans_tpu_torch as kt
from _torch_reference_runtime import ref_runtime  # noqa: F401 (fixture)
from kmeans_tpu.utils import imageio as ref_imageio
from kmeans_tpu.utils import png_py as ref_png
from kmeans_tpu_torch.utils import imageio, png_py
from kmeans_tpu_torch.utils.profiling import Timer, annotate, trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype: int, row: bytes, prev: bytes, bpp: int) -> bytes:
    """One scanline filtered by `ftype` (PNG spec, section 9.2)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        left = row[i - bpp] if i >= bpp else 0
        up = prev[i]
        ul = prev[i - bpp] if i >= bpp else 0
        pred = (0, left, up, (left + up) >> 1, _paeth(left, up, ul))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def _png(width, height, bit_depth, color_type, samples, plte=None, trns=None) -> bytes:
    """A PNG of `samples` (`[height, width * channels]` ints, each below
    2^bit_depth); row y is filtered by filter type y % 5."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if bit_depth < 8:
        bits = ((samples[..., None] >> np.arange(bit_depth - 1, -1, -1)) & 1).astype(np.uint8)
        rows = np.packbits(bits.reshape(height, -1), axis=1)
        bpp = 1
    elif bit_depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(height, -1)
        bpp = 2 * channels
    else:
        rows = samples.astype(np.uint8)
        bpp = channels
    raw, prev = bytearray(), bytes(rows.shape[1])
    for y in range(height):
        row = rows[y].tobytes()
        raw += _filter_row(y % 5, row, prev, bpp)
        prev = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, 0))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")


# (colour type, bit depth, tRNS): every colour type at every depth it
# allows, and each form of tRNS (a palette's alpha, a grey or RGB colour
# key at 8 and 16 bits and below 8).
PNG_CASES = [
    (0, 1, False), (0, 2, False), (0, 2, True), (0, 4, False), (0, 8, False), (0, 8, True),
    (0, 16, False), (0, 16, True),
    (2, 8, False), (2, 8, True), (2, 16, False), (2, 16, True),
    (3, 1, False), (3, 2, False), (3, 4, False), (3, 8, False), (3, 8, True),
    (4, 8, False), (4, 16, False),
    (6, 8, False), (6, 16, False),
]


@pytest.mark.parametrize("color_type,bit_depth,with_trns", PNG_CASES)
def test_png_decode_matches_reference(color_type, bit_depth, with_trns):
    rng = np.random.default_rng(100 * color_type + bit_depth + with_trns)
    w, h = 13, 11  # 11 rows: each filter type at least twice
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = (1 << bit_depth) - 1
    n_pal = min(top + 1, 20)
    samples = rng.integers(0, (n_pal if color_type == 3 else top + 1), (h, w * channels))
    plte = trns = None
    if color_type == 3:
        plte = rng.integers(0, 256, 3 * n_pal, dtype=np.uint8).tobytes()
        if with_trns:  # alpha for the first entries only
            trns = rng.integers(0, 256, n_pal // 2, dtype=np.uint8).tobytes()
    elif with_trns:
        key = samples[0, :channels]  # the first pixel's colour, keyed
        samples[h // 2, channels:2 * channels] = key
        trns = struct.pack(f">{channels}H", *[int(v) for v in key])
    data = _png(w, h, bit_depth, color_type, samples, plte, trns)
    want = ref_png.decode_png(data)
    got = png_py.decode_png(data)
    assert got == want
    assert got[:2] == (w, h)
    if with_trns and color_type != 3:
        alpha = np.frombuffer(got[2], np.uint8).reshape(h, w, 4)[..., 3]
        assert alpha[0, 0] == 0 and alpha[h // 2, 1] == 0


@pytest.mark.parametrize("w,h,seed", [(31, 17, 0), (1, 1, 1), (64, 64, 2)])
def test_png_encode_bytes_match_reference(w, h, seed, ref_runtime):
    rgba = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    data = png_py.encode_png(w, h, rgba.tobytes())
    assert data == ref_png.encode_png(w, h, rgba.tobytes())
    img = kt.Image((w, h), rgba)
    assert imageio.encode_png_bytes(img) == ref_imageio.encode_png_bytes(img)
    back = imageio.decode_image_bytes(data)
    assert back.dimensions == (w, h)
    np.testing.assert_array_equal(back.pixels, rgba)


def test_file_roundtrip_and_extensions(tmp_path, ref_runtime):
    rgba = np.random.default_rng(1).integers(0, 256, (10, 20, 4), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    imageio.save_image(kt.Image((20, 10), rgba), path)
    ref_imageio.save_image(kt.Image((20, 10), rgba), str(tmp_path / "ref.png"))
    with open(path, "rb") as f, open(tmp_path / "ref.png", "rb") as g:
        assert f.read() == g.read()
    img = imageio.load_image(path)
    assert isinstance(img, kt.Image) and img.dimensions == (20, 10)
    np.testing.assert_array_equal(img.pixels, rgba)
    for bad in ("x.bmp", "x.gif"):
        with pytest.raises(ValueError, match="png or jpg"):
            imageio.load_image(str(tmp_path / bad))
        with pytest.raises(ValueError, match="png or jpg"):
            imageio.save_image(img, str(tmp_path / bad))
    with pytest.raises(ValueError, match="unrecognized"):
        imageio.decode_image_bytes(b"GIF89a")


def _outcome(decode, data):
    try:
        return decode(data)
    except Exception as exc:  # the outcome compared is the exception's type
        return type(exc)


def test_png_truncated_data_as_reference():
    """A cut PNG fails with a clean exception, or (cut inside IEND) still
    decodes, the same way in both packages."""
    rgba = np.random.default_rng(7).integers(0, 256, (9, 12, 4), dtype=np.uint8)
    data = png_py.encode_png(12, 9, rgba.tobytes())
    outcomes = [_outcome(png_py.decode_png, data[:cut])
                for cut in (8, 20, len(data) // 2, len(data) - 5)]
    assert outcomes == [_outcome(ref_png.decode_png, data[:cut])
                        for cut in (8, 20, len(data) // 2, len(data) - 5)]
    assert all(isinstance(o, type) for o in outcomes[:3]), outcomes
    with pytest.raises(ValueError, match="not a PNG"):
        png_py.decode_png(b"\x00" * 16)


def test_decode_limit_refuses_dimension_bombs():
    ihdr = struct.pack(">IIBBBBB", 100_000, 100_000, 8, 6, 0, 0, 0)
    bomb = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"\x00" * 10)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="decode limit"):
        png_py.decode_png(bomb)
    old = imageio.get_max_decode_pixels()
    assert old == ref_imageio.get_max_decode_pixels() == 512 * 1024 * 1024
    data = imageio.encode_png_bytes(kt.Image((64, 64), np.zeros((64, 64, 4), np.uint8)))
    try:
        assert imageio.set_max_decode_pixels(1000) == old
        assert imageio.get_max_decode_pixels() == png_py.max_decode_pixels() == 1000
        with pytest.raises(ValueError, match="decode limit"):
            imageio.decode_image_bytes(data)
        with pytest.raises(ValueError, match="positive"):
            imageio.set_max_decode_pixels(0)
    finally:
        imageio.set_max_decode_pixels(old)
    assert imageio.decode_image_bytes(data).dimensions == (64, 64)


@pytest.mark.parametrize("value,ok", [("4096", True), ("lots", False)])
def test_decode_limit_from_environment(value, ok):
    """`KMEANS_TPU_MAX_DECODE_PIXELS` is read when the module is imported,
    as the reference reads it (a fresh interpreter, without JAX)."""
    code = ("from kmeans_tpu_torch.utils import imageio; "
            "print(imageio.get_max_decode_pixels())")
    env = {**os.environ, "KMEANS_TPU_MAX_DECODE_PIXELS": value,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=120)
    if ok:
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip().splitlines()[-1] == value
    else:
        assert r.returncode != 0
        assert "KMEANS_TPU_MAX_DECODE_PIXELS must be a positive integer" in r.stderr


def test_jpeg_and_gif_through_the_native_codec(tmp_path, ref_runtime):
    """JPEG and GIF through each package's `utils/imageio.py` with its
    native runtime: `save_image` to .jpg, `decode_image_bytes` of a JPEG,
    `save_gif` / `encode_gif_bytes` with per-frame delays and `load_gif` /
    `decode_gif_bytes` give the same bytes and pixels in both."""
    assert imageio.HAVE_NATIVE is True and ref_imageio.HAVE_NATIVE is True
    rng = np.random.default_rng(4)
    img = kt.Image((24, 16), rng.integers(0, 256, (16, 24, 4), dtype=np.uint8))
    files = []
    for module, name in ((imageio, "port"), (ref_imageio, "ref")):
        module.save_image(img, str(tmp_path / f"{name}.jpg"), quality=75)
        with open(tmp_path / f"{name}.jpg", "rb") as f:
            files.append(f.read())
    assert files[0] == files[1] and files[0][:2] == b"\xff\xd8"
    got, want = imageio.decode_image_bytes(files[0]), ref_imageio.decode_image_bytes(files[0])
    assert got.dimensions == want.dimensions == (24, 16)
    np.testing.assert_array_equal(got.pixels, want.pixels)
    frames = [kt.Image((6, 5), np.repeat(rng.integers(0, 256, (5, 1, 4), dtype=np.uint8), 6, 1))
              for _ in range(3)]
    for f in frames:
        f.pixels[..., 3] = 255
    gifs = []
    for module, name in ((imageio, "port"), (ref_imageio, "ref")):
        module.save_gif(frames, str(tmp_path / f"{name}.gif"), delays=[3, 30, 300])
        gifs.append(module.encode_gif_bytes(frames, delay_cs=7, loop=False))
        with open(tmp_path / f"{name}.gif", "rb") as f:
            gifs.append(f.read())
    assert gifs[:2] == gifs[2:]
    back, delays = imageio.load_gif(str(tmp_path / "port.gif"), with_delays=True)
    ref_back = ref_imageio.decode_gif_bytes(gifs[1])
    assert delays == [3, 30, 300] and len(back) == len(ref_back) == 3
    for a, b, c in zip(back, ref_back, frames):
        np.testing.assert_array_equal(a.pixels, b.pixels)
        np.testing.assert_array_equal(a.pixels, c.pixels)
    assert imageio.decode_gif_bytes(gifs[0], with_delays=True)[1] == [7, 7, 7]


def test_without_the_png_jpeg_unit_as_reference_without_its_extension(tmp_path, monkeypatch):
    """On a host without libpng's and libjpeg's headers (the runtime's PNG
    and JPEG unit cannot build there), PNG takes the pure-Python codec and
    JPEG is refused, with the reference's bytes and errors when it runs
    without its extension; GIF still runs the runtime's core unit, and the
    fuzz tool fuzzes what is there."""
    from kmeans_tpu_torch import runtime
    from kmeans_tpu_torch.tools import fuzz_codec

    monkeypatch.setattr(runtime, "codec_available", lambda: False)
    assert imageio.HAVE_NATIVE is False and ref_imageio.HAVE_NATIVE is False
    rgba = np.random.default_rng(5).integers(0, 256, (9, 14, 4), dtype=np.uint8)
    img = kt.Image((14, 9), rgba)
    data = imageio.encode_png_bytes(img)
    assert data == ref_imageio.encode_png_bytes(img) == ref_png.encode_png(14, 9, rgba.tobytes())
    np.testing.assert_array_equal(imageio.decode_image_bytes(data).pixels, rgba)
    jpeg = b"\xff\xd8\xff\xe0" + bytes(16)
    for module in (imageio, ref_imageio):
        with pytest.raises(RuntimeError, match="JPEG support requires the native runtime"):
            module.decode_image_bytes(jpeg)
        with pytest.raises(RuntimeError, match="JPEG support requires the native runtime"):
            module.save_image(img, str(tmp_path / "a.jpg"))
    frames = [kt.Image((14, 9), np.full((9, 14, 4), 40 * i, np.uint8)) for i in range(1, 4)]
    back, delays = imageio.decode_gif_bytes(imageio.encode_gif_bytes(frames, delays=[2, 3, 4]),
                                            with_delays=True)
    assert delays == [2, 3, 4]
    for a, b in zip(back, frames):
        np.testing.assert_array_equal(a.pixels[..., :3], b.pixels[..., :3])
    assert fuzz_codec.run(100, 7) == 0


def test_copied_and_borrowed_pixel():
    rgba = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    copied, borrowed = kt.copied_pixel((3, 2), rgba), kt.borrowed_pixel((3, 2), rgba)
    assert copied.dimensions == borrowed.dimensions == (3, 2)
    assert not np.shares_memory(copied.pixels, rgba)
    assert np.shares_memory(borrowed.pixels, rgba)
    flat = kt.borrowed_pixel((3, 2), rgba.reshape(-1))
    np.testing.assert_array_equal(flat.pixels, rgba)
    with pytest.raises(ValueError):
        kt.copied_pixel((2, 2), rgba)


def test_timer_and_annotate():
    with Timer("section") as t:
        with annotate("labelled-region"):
            torch.arange(16).sum()
    assert t.elapsed > 0


def test_trace_writes_files(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("inside-trace"):
            torch.ones((8, 8)).sum()
    names = os.listdir(d)
    assert names and all(n.endswith(".json") for n in names)
    with open(os.path.join(d, names[0])) as f:
        assert "inside-trace" in f.read()
