"""The slice end to end: `kmeans_tpu_torch.ImageProcessor(device="cpu")`
against `kmeans_tpu.ImageProcessor()` on the JAX CPU backend.

The image is the benchmark's gradient-plus-noise recipe at 300x420. The
palettes' RGBA8 must be equal and at least 99.99% of the output pixels
identical; the differing ones are counted. They come from near-ties: the
reference's jitted XLA chain contracts some float ops into FMAs, and the
port's cube root is torch's `pow`.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu_torch.interop import palette_from_reference
from kmeans_tpu_torch.ops import kernels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
H, W = 300, 420


def _image(h=H, w=W, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


@pytest.fixture(scope="module")
def processors():
    return kmeans_tpu.ImageProcessor(), kt.ImageProcessor(device="cpu")


def _assert_close_images(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8
    differ = int((got != want).any(-1).sum())
    print(f"{what}: {differ} of {H * W} pixels differ")
    assert differ <= H * W // 10000, differ


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER"])
@pytest.mark.parametrize("k", [2, 8, 17])
def test_reduce_and_palette_match_reference(processors, k, mode):
    ref, port = processors
    img = _image()
    np.testing.assert_array_equal(port.palette(k, img), ref.palette(k, img))
    want = ref.reduce(k, img, reduce_mode=getattr(kmeans_tpu.ReduceMode, mode)).pixels
    got = port.reduce(k, img, reduce_mode=getattr(kt.ReduceMode, mode))
    assert isinstance(got, kt.Image) and got.dimensions == (W, H)
    assert (got.pixels[..., 3] == 255).all()
    assert len(np.unique(got.pixels.reshape(-1, 4), axis=0)) <= k
    _assert_close_images(got.pixels, want, f"reduce k={k} {mode}")


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER"])
def test_find_matches_reference(processors, mode):
    ref, port = processors
    img = _image(seed=4)
    rng = np.random.default_rng(5)
    colors = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    want = ref.find(img, colors, getattr(kmeans_tpu.ReduceMode, mode)).pixels
    got = port.find(img, colors, getattr(kt.ReduceMode, mode)).pixels
    _assert_close_images(got, want, f"find {mode}")


def test_find_with_the_reference_palette(processors):
    """The reference's trained palette, carried over as a tensor, recolours
    the image as the reference's own `find` does."""
    ref, port = processors
    img = _image(seed=7)
    pal = ref.palette(6, img)
    carried = palette_from_reference(pal[:, :3])
    assert carried.shape == (6, 4) and (carried[:, 3] == 255).all()
    want = ref.find(img, pal, kmeans_tpu.ReduceMode.DITHER).pixels
    got = port.find(img, carried, kt.ReduceMode.DITHER).pixels
    _assert_close_images(got, want, "find with the reference palette")


def test_rgb_color_space_palette(processors):
    ref, port = processors
    img = kt.Image((W, H), _image(seed=6))
    got = port.extract_palette_kmeans(img, 5, kt.ColorSpace.RGB).numpy()
    want = np.asarray(
        ref.extract_palette_kmeans(kmeans_tpu.Image((W, H), img.pixels), 5,
                                   kmeans_tpu.ColorSpace.RGB)
    )
    # Training sums reduce in another order than XLA's: within 1e-4 of the
    # [0, 1] range, and the same colours once rounded to u8.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.round(got * 255), np.round(want * 255))


def test_cpu_path_launches_no_kernel(processors, monkeypatch):
    _, port = processors
    monkeypatch.setattr(kernels, "ASSIGN_PACKED_LAUNCHES", 0)
    port.reduce(4, _image(40, 50))
    port.find(_image(40, 50), [[0, 0, 0], [255, 255, 255]])
    assert kernels.ASSIGN_PACKED_LAUNCHES == 0


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kt.ImageProcessor()
    with pytest.raises(RuntimeError):
        kt.ImageProcessor(device="cuda")


@pytest.mark.parametrize(
    "kwargs,item",
    [({"delta_e": "2000"}, "B4"), ({"bucketing": True}, "A.9"),
     ({"fast": True}, "B5"), ({"pipeline": True}, "A.13")],
)
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        kt.ImageProcessor(device="cpu", **kwargs)


@pytest.mark.parametrize(
    "kwargs", [{"restarts": 2}, {"train_dtype": "bfloat16"}, {"train_dtype": "float32"}]
)
def test_ported_options_accepted(processors, kwargs):
    """Options the reference routes through its trainers run here too; on
    the shrunk image `train_dtype` changes nothing (it reaches only the
    accumulator's planes)."""
    port = kt.ImageProcessor(device="cpu", **kwargs)
    img = _image(40, 50)
    pal = port.palette(4, img)
    if "train_dtype" in kwargs:
        np.testing.assert_array_equal(pal, processors[1].palette(4, img))
    with pytest.raises(ValueError):
        kt.ImageProcessor(device="cpu", train_dtype="float16")


def test_unported_modes_raise(processors):
    _, port = processors
    img = _image(20, 30)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        port.reduce(4, img, reduce_mode=kt.ReduceMode.MELD)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        port.find(img, [[1, 2, 3]], kt.ReduceMode.MELD)
    for algo in (kt.Algorithm.OCTREE, kt.Algorithm.WU, kt.Algorithm.MEDIANCUT):
        with pytest.raises(NotImplementedError):
            port.reduce(4, img, algo)
        with pytest.raises(NotImplementedError):
            port.palette(4, img, algo)
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        port.reduce(1025, img)
    with pytest.raises(ValueError):
        port.reduce(0, img)
    with pytest.raises(ValueError):
        kt.ImageProcessor(device="cpu", delta_e="76")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_and_chip_smoke_never_import_jax():
    """Static check (JAX may already be imported in this process): no
    module of the port, and not chip_smoke.py, imports jax or kmeans_tpu."""
    files = sorted((ROOT / "kmeans_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "kmeans_tpu"), (path, name)
        text = path.read_text()
        assert "__import__" not in text and "import_module" not in text, path


def test_phases_cover_the_reduce_path(processors):
    """The phase recorder bills a reduce to its host and device phases, and
    records nothing outside a `collect_phases` block."""
    from kmeans_tpu_torch.utils.profiling import collect_phases

    _, port = processors
    phases: dict = {}
    with collect_phases(phases):
        port.reduce(4, _image(40, 50))
    assert {"host_prep", "upload", "device", "readback", "unpack"} <= set(phases)
    assert all(v >= 0 for v in phases.values())
    assert "_syncs" not in phases  # the CPU needs no device waits
    snapshot = dict(phases)
    port.reduce(4, _image(40, 50))
    assert phases == snapshot
