"""PyTorch port vs the JAX package: the native codec.

`kmeans_tpu_torch/runtime/` (the port's copy of `kmeans_tpu/runtime/_imagio.c`,
built with the host's C compiler at first use) against the reference's
extension, built for these tests (`_torch_reference_runtime.py`), and
against the pure-Python PNG codec:

- PNG decodes equal `png_py`'s on every colour type, bit depth and tRNS
  case of `tests/test_torch_imageio.py`, and the reference runtime's;
- encodes give the reference runtime's bytes: RGBA PNG, palette PNG through
  `_encode_png_auto` (and RGBA past 256 colours), JPEG at quality 90 and
  75, GIF with per-frame delays, with and without the loop extension;
- JPEG and GIF decodes equal the reference's, GIFs with sub-frames,
  disposal 2 and 3, transparency, interlacing and a global colour table
  included;
- dimension bombs raise `ValueError` naming the decode limit, corrupt and
  truncated data raise `ValueError` where the reference's does, and bad
  encode arguments raise as the reference's;
- eight threads decoding at once give the single-thread results;
- the port's fuzz tool (`kmeans_tpu_torch/tools/fuzz_codec.py`, 300
  mutants, seed 42) loses no worker.
"""

import os
import struct
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_reference_runtime import ref_runtime  # noqa: F401 (fixture)
from kmeans_tpu.utils import imageio as ref_imageio
from kmeans_tpu_torch import runtime
from kmeans_tpu_torch.image import Image
from kmeans_tpu_torch.utils import imageio, png_py
from test_torch_imageio import PNG_CASES, _png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case_png(color_type, bit_depth, with_trns):
    """test_torch_imageio.py's PNG of one colour type, depth and tRNS case."""
    rng = np.random.default_rng(100 * color_type + bit_depth + with_trns)
    w, h = 13, 11
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = (1 << bit_depth) - 1
    n_pal = min(top + 1, 20)
    samples = rng.integers(0, (n_pal if color_type == 3 else top + 1), (h, w * channels))
    plte = trns = None
    if color_type == 3:
        plte = rng.integers(0, 256, 3 * n_pal, dtype=np.uint8).tobytes()
        if with_trns:
            trns = rng.integers(0, 256, n_pal // 2, dtype=np.uint8).tobytes()
    elif with_trns:
        key = samples[0, :channels]
        samples[h // 2, channels:2 * channels] = key
        trns = struct.pack(f">{channels}H", *[int(v) for v in key])
    return _png(w, h, bit_depth, color_type, samples, plte, trns)


@pytest.mark.parametrize("color_type,bit_depth,with_trns", PNG_CASES)
def test_png_decode_equals_png_py_and_reference(color_type, bit_depth, with_trns, ref_runtime):
    data = _case_png(color_type, bit_depth, with_trns)
    got = runtime.decode_png(data)
    assert got == png_py.decode_png(data)
    assert got == ref_runtime.decode_png(data)


def _noise(w, h, seed, alpha=True):
    rgba = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    if not alpha:
        rgba[..., 3] = 255
    return rgba


@pytest.mark.parametrize("w,h,seed", [(31, 17, 0), (1, 1, 1), (64, 64, 2), (300, 7, 3)])
def test_rgba_png_and_jpeg_encode_bytes(w, h, seed, ref_runtime):
    rgba = _noise(w, h, seed)
    data = runtime.encode_png(w, h, rgba.tobytes())
    assert data == ref_runtime.encode_png(w, h, rgba.tobytes())
    assert runtime.decode_png(data) == (w, h, rgba.tobytes())
    for q in (90, 75):
        jpeg = runtime.encode_jpeg(w, h, rgba, q)
        assert jpeg == ref_runtime.encode_jpeg(w, h, rgba.tobytes(), q)
        assert runtime.decode_jpeg(jpeg) == ref_runtime.decode_jpeg(jpeg)
    assert runtime.encode_jpeg(w, h, rgba) == ref_runtime.encode_jpeg(w, h, rgba.tobytes())


@pytest.mark.parametrize("n_colors,alpha", [(1, False), (3, False), (17, True), (256, False),
                                            (257, False)])
def test_encode_png_auto_bytes(n_colors, alpha, ref_runtime):
    """`_encode_png_auto` writes a palette PNG (with tRNS where an entry is
    not opaque) up to 256 colours and RGBA past them: the reference's bytes
    and a lossless round trip. 120x90 pixels: the 4096-pixel sample misses
    colours, which the search adds."""
    rng = np.random.default_rng(n_colors)
    pal = rng.integers(0, 256, (n_colors, 4), dtype=np.uint8)
    if not alpha:
        pal[:, 3] = 255
    pal = np.unique(pal, axis=0)
    idx = rng.integers(0, len(pal), (90, 120))
    img = Image((120, 90), pal[idx])
    data = imageio.encode_png_bytes(img)
    assert data == ref_imageio.encode_png_bytes(img)
    assert data[25] == (3 if len(pal) <= 256 else 6)  # IHDR colour type
    assert (b"tRNS" in data) == (alpha and len(pal) <= 256)
    np.testing.assert_array_equal(imageio.decode_image_bytes(data).pixels, img.pixels)


def _gif_frames(n, w, h, seed, colors=5):
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., :3] = pal[rng.integers(0, colors, (h, w))]
        frames.append(Image((w, h), rgba))
    return frames


@pytest.mark.parametrize("loop", [True, False])
def test_gif_encode_bytes_and_decode(loop, ref_runtime):
    """GIF bytes with per-frame delays equal the reference's (a frame of 1,
    2, 5 and 200 colours: colour tables of 2 to 256 entries), and each
    decoder gives the frames and delays back."""
    frames = []
    for i, colors in enumerate((1, 2, 5, 200)):
        frames += _gif_frames(1, 37, 23, i, colors)
    delays = [0, 7, 65535, 300]
    data = imageio.encode_gif_bytes(frames, delay_cs=9, loop=loop, delays=delays)
    assert data == ref_imageio.encode_gif_bytes(frames, delay_cs=9, loop=loop, delays=delays)
    assert (b"NETSCAPE2.0" in data) == loop
    w, h, got, got_delays = runtime.decode_gif(data)
    assert (w, h, got, got_delays) == ref_runtime.decode_gif(data)
    assert got_delays == delays
    for buf, frame in zip(got, frames):
        assert buf == frame.pixels.tobytes()
    uniform = imageio.encode_gif_bytes(frames[:2], delay_cs=12)
    assert runtime.decode_gif(uniform)[3] == [12, 12]


def _lzw_block(iw, ih, indices, colors):
    """`(min code size, LZW sub-blocks)` of `indices` (`[ih, iw]`, below
    `colors`), cut from a one-frame GIF the codec writes."""
    pal = np.zeros((colors, 3), np.uint8).tobytes()
    data = runtime.encode_gif(iw, ih, [(pal, indices.astype(np.uint8).tobytes())], 0, False)
    bits = (data[13 + 8 + 9] & 7) + 1
    start = 13 + 8 + 10 + 3 * (1 << bits)
    return data[start:-1]


def _composed_gif(width, height, frames, gct=None):
    """A GIF89a of `frames`: each `(ix, iy, iw, ih, indices, lct, disposal,
    transparent, delay, interlaced)`, indices `[ih, iw]` in stored row order
    (for an interlaced frame, the passes' order)."""
    flags = 0
    table = b""
    if gct is not None:
        bits = max(1, int(np.ceil(np.log2(len(gct) // 3))))
        flags = 0x80 | (bits - 1)
        table = gct + bytes(3 * (1 << bits) - len(gct))
    out = b"GIF89a" + struct.pack("<HHBBB", width, height, flags, 0, 0) + table
    for ix, iy, iw, ih, indices, lct, disposal, transparent, delay, interlaced in frames:
        gflags = (disposal << 2) | (transparent is not None)
        out += b"\x21\xf9\x04" + struct.pack("<BHB", gflags, delay, transparent or 0) + b"\x00"
        iflags = 0x40 if interlaced else 0
        lct_bytes = b""
        if lct is not None:
            bits = max(1, int(np.ceil(np.log2(len(lct) // 3))))
            iflags |= 0x80 | (bits - 1)
            lct_bytes = lct + bytes(3 * (1 << bits) - len(lct))
        colors = len(lct if lct is not None else gct) // 3
        out += b"\x2c" + struct.pack("<HHHHB", ix, iy, iw, ih, iflags) + lct_bytes
        out += _lzw_block(iw, ih, indices, colors)
    return out + b"\x3b"


def _compositing_gifs():
    rng = np.random.default_rng(21)
    lct = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()  # 4 colours
    gct = rng.integers(0, 256, 6, dtype=np.uint8).tobytes()  # 2 colours

    def idx(h, w, n=4):
        return rng.integers(0, n, (h, w))

    full = (0, 0, 20, 12, idx(12, 20), lct, 0, None, 10, False)
    return {
        "disposal_none_transparent": _composed_gif(20, 12, [
            full, (3, 2, 9, 7, idx(7, 9), lct, 1, 2, 20, False)]),
        "disposal_background": _composed_gif(20, 12, [
            (0, 0, 20, 12, idx(12, 20), lct, 2, None, 5, False),
            (4, 4, 10, 5, idx(5, 10), lct, 0, 0, 6, False)]),
        "disposal_previous": _composed_gif(20, 12, [
            full, (2, 1, 8, 8, idx(8, 8), lct, 3, None, 4, False),
            (5, 3, 6, 6, idx(6, 6), lct, 0, 1, 3, False)]),
        "interlaced": _composed_gif(20, 12, [(0, 0, 20, 12, idx(12, 20), lct, 0, None, 8, True),
                                             (1, 1, 7, 9, idx(9, 7), lct, 0, 3, 2, True)]),
        "global_table": _composed_gif(16, 9, [(0, 0, 16, 9, idx(9, 16, 2), None, 0, None, 1,
                                               False)], gct=gct),
    }


@pytest.mark.parametrize("case", sorted(_compositing_gifs()))
def test_gif_compositing_equals_reference(case, ref_runtime):
    data = _compositing_gifs()[case]
    got = runtime.decode_gif(data)
    assert got == ref_runtime.decode_gif(data)
    frames, delays = imageio.decode_gif_bytes(data, with_delays=True)
    assert len(frames) == len(got[2]) >= 1 and delays == got[3]


def test_gif_compositing_semantics():
    """Disposal 2 clears the frame's rectangle to transparent black before
    the next frame; a transparent index keeps the canvas below."""
    w, h, frames, _ = runtime.decode_gif(_compositing_gifs()["disposal_background"])
    second = np.frombuffer(frames[1], np.uint8).reshape(h, w, 4)
    assert (second[:4] == 0).all() and (second[9:] == 0).all()  # outside frame 2: cleared


def _bomb_gif():
    """The reference's: a 65535x65535 screen in a few bytes."""
    h = b"GIF89a" + struct.pack("<HH", 65535, 65535) + bytes([0x00, 0, 0])
    desc = b"\x2c" + struct.pack("<HHHH", 0, 0, 1, 1) + bytes([0x80])
    return h + desc[:10] + bytes(6) + desc[10:] + bytes([2, 1, 0x44, 0]) + b"\x3b"


def _bomb_png():
    ihdr = struct.pack(">IIBBBBB", 100_000, 100_000, 8, 6, 0, 0, 0)

    def chunk(ctype, payload):
        c = ctype + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(">I", zlib.crc32(c))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"\x00" * 10)) + chunk(b"IEND", b""))


def _bomb_jpeg():
    """A valid JPEG with its SOF0 dimensions set to 60000x60000."""
    data = bytearray(runtime.encode_jpeg(8, 8, bytes(256)))
    i = data.index(b"\xff\xc0")
    data[i + 5:i + 9] = struct.pack(">HH", 60000, 60000)
    return bytes(data)


def test_dimension_bombs_name_the_decode_limit(ref_runtime):
    for decode, ref_decode, bomb in ((runtime.decode_gif, ref_runtime.decode_gif, _bomb_gif()),
                                     (runtime.decode_png, ref_runtime.decode_png, _bomb_png()),
                                     (runtime.decode_jpeg, ref_runtime.decode_jpeg,
                                      _bomb_jpeg())):
        for fn in (decode, ref_decode):
            with pytest.raises(ValueError, match="decode limit"):
                fn(bomb)
    # A GIF within the per-frame budget but past it summed over frames.
    frames = _gif_frames(3, 40, 40, 5)
    data = imageio.encode_gif_bytes(frames)
    old = imageio.set_max_decode_pixels(2 * 40 * 40)
    try:
        assert runtime.get_max_decode_pixels() == 3200
        with pytest.raises(ValueError, match="limit of 3200 total pixels"):
            imageio.decode_gif_bytes(data)
        with pytest.raises(ValueError, match="decode limit"):
            imageio.decode_image_bytes(runtime.encode_png(60, 60, bytes(60 * 60 * 4)))
    finally:
        imageio.set_max_decode_pixels(old)
    assert len(imageio.decode_gif_bytes(data)) == 3
    with pytest.raises(ValueError, match="positive"):
        runtime.set_max_decode_pixels(0)


def _outcome(fn, data):
    try:
        return fn(data)
    except Exception as exc:  # the outcome compared is the exception's type
        return type(exc)


def test_corrupt_and_truncated_data_as_reference(ref_runtime):
    png = runtime.encode_png(9, 7, _noise(9, 7, 1).tobytes())
    jpeg = runtime.encode_jpeg(9, 7, _noise(9, 7, 1))
    gif = imageio.encode_gif_bytes(_gif_frames(2, 9, 7, 2))
    cases = [(runtime.decode_png, ref_runtime.decode_png, png),
             (runtime.decode_jpeg, ref_runtime.decode_jpeg, jpeg),
             (runtime.decode_gif, ref_runtime.decode_gif, gif)]
    for decode, ref_decode, data in cases:
        for cut in (0, 3, 8, 20, len(data) // 2, len(data) - 2):
            assert _outcome(decode, data[:cut]) == _outcome(ref_decode, data[:cut])
    with pytest.raises(ValueError, match="not a GIF"):
        runtime.decode_gif(b"GIF89a\x00")
    with pytest.raises(ValueError, match="invalid PNG"):
        runtime.decode_png(png[: len(png) // 2])


def test_encode_arguments_rejected_as_reference(ref_runtime):
    bad = [
        ("encode_gif", (2, 1, [(bytes([255, 0, 0, 0, 255, 0]), bytes([0, 5]))], 100, True)),
        ("encode_gif", (0, 0, [(bytes([1, 2, 3]), b"")], 100, True)),
        ("encode_gif", (2, 1, [], 100, True)),
        ("encode_gif", (1, 1, [(bytes(3 * 257), b"\x00")], 100, True)),
        ("encode_png", (2, 2, bytes(15))),
        ("encode_jpeg", (2, 2, bytes(17), 90)),
        ("encode_png_indexed", (2, 1, bytes(8), bytes([0, 2]))),
        ("encode_png_indexed", (2, 1, bytes(4 * 257), bytes(2))),
    ]
    for name, args in bad:
        for module in (runtime, ref_runtime):
            with pytest.raises(ValueError):
                getattr(module, name)(*args)


def test_concurrent_decodes_equal_serial():
    """Eight threads decoding PNG, JPEG and GIF at once (the runtime runs
    outside the interpreter lock) give the one-thread results."""
    payloads = []
    for i in range(8):
        rgba = _noise(160 + i, 90, i, alpha=False)
        payloads += [(runtime.decode_png, runtime.encode_png(160 + i, 90, rgba)),
                     (runtime.decode_jpeg, runtime.encode_jpeg(160 + i, 90, rgba)),
                     (runtime.decode_gif, imageio.encode_gif_bytes(_gif_frames(3, 50, 40, i)))]
    want = [fn(data) for fn, data in payloads]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(3):
            got = list(pool.map(lambda p: p[0](p[1]), payloads))
            assert got == want


def test_codec_fuzz_smoke():
    """tests/test_imageio.py::test_codec_fuzz_smoke on the port's runtime: no
    worker dies across 300 mutants (seed 42)."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-m", "kmeans_tpu_torch.tools.fuzz_codec", "300", "42"],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "fuzz: 300 mutants, 0 crashing batch(es)" in r.stdout
