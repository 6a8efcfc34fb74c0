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


def test_cpu_path_launches_no_kernel(processors):
    _, port = processors
    kernels.LAUNCHES_BY_MODE.clear()
    port.reduce(4, _image(40, 50))
    port.find(_image(40, 50), [[0, 0, 0], [255, 255, 255]])
    port.find(_image(40, 50), [[0, 0, 0], [255, 255, 255]], kt.ReduceMode.MELD)
    assert kernels.launches("assign_packed") == kernels.launches("meld_packed") == 0


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kt.ImageProcessor()
    with pytest.raises(RuntimeError):
        kt.ImageProcessor(device="cuda")


@pytest.mark.parametrize("kwargs", [
    pytest.param({"pipeline": True}, id="kwargs0-A.13"),
    pytest.param({"pipeline": True, "bucketing": True}, id="kwargs1-A.13"),
    pytest.param({"fast": True, "pipeline": True}, id="kwargs2-A.13"),
])
def test_unported_options_raise(kwargs):
    """The options that were refused until ROADMAP A.13 was ported now
    construct, and the first palette equals the reference's at the same
    options, on an image past the training cap: the host-shrunk strip
    trains (tests/test_torch_pipeline.py holds the rest of pipeline mode)."""
    port = kt.ImageProcessor(device="cpu", **kwargs)
    assert port.pipeline is True
    img = _image()
    np.testing.assert_array_equal(port.palette(8, img),
                                  kmeans_tpu.ImageProcessor(**kwargs).palette(8, img))


@pytest.mark.parametrize("method,args", [
    ("reduce_many", ([], 4)), ("find_many", ([], [[0, 0, 0]])), ("palette_many", ([], 4)),
    ("warmup", ([(8, 8)], [4])),
])
def test_unported_batch_methods_raise(processors, method, args):
    """The coalescers refuse an empty batch and `warmup` an unbucketed
    processor, with the reference's `ValueError`s; with images they run
    (tests/test_torch_many.py, and per image without bucketing)."""
    with pytest.raises(ValueError):
        getattr(processors[1], method)(*args)


@pytest.mark.parametrize("method", [
    "find_sharded", "palette_sharded", "reduce_sharded", "reduce_images_sharded",
    "palette_images_sharded", "find_batch_sharded",
])
def test_sharded_entry_points_run_on_cpu_mesh(processors, method):
    """The reference's six sharded entry points run on a CPU mesh of two
    shards and on the default mesh (`mesh=None`: the CPU alone for a CPU
    processor), with and without bucketing, and give what the processor's
    single-device call gives on this small image
    (tests/test_torch_sharded.py holds them to the reference)."""
    from kmeans_tpu_torch.parallel import make_mesh

    img = _image(8, 8)
    arg = [img, img] if method in ("reduce_images_sharded", "palette_images_sharded",
                                   "find_batch_sharded") else img
    single = method.replace("_sharded", "")
    for port in (processors[1], kt.ImageProcessor(device="cpu", bucketing=True)):
        call_args = (arg, [[1, 2, 3], [200, 100, 50]]) if method.startswith("find") else (
            (4, arg) if method in ("palette_sharded", "reduce_sharded") else (arg, 4))
        want = getattr(port, single)(*call_args)
        for mesh in (make_mesh(["cpu"] * 2), None):
            got = getattr(port, method)(*call_args, mesh=mesh)
            for g, w in zip(got if isinstance(got, list) else [got],
                            want if isinstance(want, list) else [want]):
                np.testing.assert_array_equal(getattr(g, "pixels", g), getattr(w, "pixels", w))


@pytest.mark.parametrize(
    "kwargs", [{"restarts": 2}, {"train_dtype": "bfloat16"}, {"train_dtype": "float32"},
               {"fast": True}]
)
def test_ported_options_accepted(processors, kwargs):
    """Options the reference routes through its trainers run here too; on
    the shrunk image `train_dtype` changes nothing (it reaches only the
    accumulator's planes), and at k = 4 neither does `fast` (it acts at
    16 < k <= 512; tests/test_torch_fast.py drives it there)."""
    port = kt.ImageProcessor(device="cpu", **kwargs)
    img = _image(40, 50)
    pal = port.palette(4, img)
    if "restarts" not in kwargs:
        np.testing.assert_array_equal(pal, processors[1].palette(4, img))
    with pytest.raises(ValueError):
        kt.ImageProcessor(device="cpu", train_dtype="float16")


def test_unported_modes_raise(processors):
    """Meld runs, and so do replace and dither past 1024 colours (any
    palette size; tests/test_torch_colour_out.py holds them to the
    reference) and the host palette algorithms (their palettes the
    reference's; tests/test_torch_palette_algos.py holds their routes),
    and so does pipeline mode (ROADMAP A.13); bad arguments raise."""
    ref, port = processors
    img = _image(20, 30)
    assert port.reduce(4, img, reduce_mode=kt.ReduceMode.MELD).pixels.shape == (20, 30, 4)
    one = port.find(img, [[1, 2, 3]], kt.ReduceMode.MELD).pixels
    assert (one.reshape(-1, 4) == [1, 2, 3, 255]).all()
    big = port.find(img, np.zeros((1025, 3), np.uint8), kt.ReduceMode.DITHER).pixels
    assert (big.reshape(-1, 4) == [0, 0, 0, 255]).all()
    for algo in ("OCTREE", "WU", "MEDIANCUT"):
        assert port.reduce(4, img, kt.Algorithm[algo]).pixels.shape == (20, 30, 4)
        np.testing.assert_array_equal(port.palette(4, img, kt.Algorithm[algo]),
                                      ref.palette(4, img, kmeans_tpu.Algorithm[algo]))
    sharded = port.find_sharded(img, [[1, 2, 3]]).pixels  # A.12 runs (one-shard CPU mesh)
    assert (sharded.reshape(-1, 4) == [1, 2, 3, 255]).all()
    piped = kt.ImageProcessor(device="cpu", pipeline=True)  # A.13 runs
    np.testing.assert_array_equal(piped.reduce(4, img).pixels, port.reduce(4, img).pixels)
    with pytest.raises(ValueError):
        port.reduce(0, img)
    with pytest.raises(ValueError):
        kt.ImageProcessor(device="cpu", delta_e="76")


@pytest.mark.parametrize("module", ["kmeans_tpu", "kmeans_tpu.ops", "kmeans_tpu.utils"])
def test_public_names_match_reference(module):
    """Every name in the reference package's `__all__` lists exists in the
    port's counterpart, and the port's lists hold them, but one:
    `enable_compilation_cache`, the XLA compile cache (ROADMAP A.13: the
    port compiles nothing per shape; its CUDA library builds once into a
    hashed directory)."""
    import importlib

    ref = importlib.import_module(module)
    port = importlib.import_module(module.replace("kmeans_tpu", "kmeans_tpu_torch", 1))
    names = [n for n in ref.__all__ if n != "enable_compilation_cache"]
    assert [n for n in names if not hasattr(port, n)] == []
    assert sorted(port.__all__) == sorted(names)
    assert getattr(port, "__version__", None) == getattr(ref, "__version__", None)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_and_chip_smoke_never_import_jax():
    """Static check (JAX may already be imported in this process): no
    module of the port (`parallel/` included), and not chip_smoke.py,
    imports jax, kmeans_tpu, the reference's experiment tools (`tools/`)
    or `torch.distributed` (the meshes are one process)."""
    files = sorted((ROOT / "kmeans_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {"delta_e.py", "kernels.py", "quantize.py", "packing.py", "exp_mxu.py",
            "exp_gather.py", "_exp.py", "mesh.py", "collectives.py", "distributed.py",
            "sharded_ops.py"} <= {f.name for f in files}
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "kmeans_tpu", "tools"), (path, name)
            assert not name.startswith("torch.distributed"), (path, name)
        text = path.read_text()
        assert "__import__" not in text and "import_module" not in text, path


def test_port_never_touches_matmul_precision_flags():
    """Static check: no module of the port reads or sets a process-wide
    matmul-precision setting (a serving thread could race it); the
    training product is pinned by its float64 form instead."""
    names = ("allow_tf32", "fp32_precision", "float32_matmul_precision")
    for path in sorted((ROOT / "kmeans_tpu_torch").rglob("*.py")):
        text = path.read_text()
        assert not any(name in text for name in names), path


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
