"""PyTorch port vs the JAX package: pipeline mode (ROADMAP A.13).

`kmeans_tpu_torch.ImageProcessor(device="cpu", pipeline=True)` against
`kmeans_tpu.ImageProcessor(pipeline=True)` on the JAX CPU backend, and
against the port's own default path:

- the host sampler `ops/resize.py::resize_uint8_np` gives the reference's
  bytes (0 differing) at every tested shape;
- the palette family trains on the host-shrunk strip: `palette` and
  `palette_images` equal the reference's on the 700x520 blob image of
  `tests/test_api.py::test_pipelined_palette_matches_default`, and every
  other member (no shrink, the host algorithms, bucketed, `palette_many`)
  equals the port's default path, as the reference asserts of its own on
  the CPU; the uploads are the strips', and the host algorithms upload
  nothing; `warmup` issues the reference's count of dummy requests;
- the banded `reduce` on a 2100x64 image (5 bands, the last of 52 rows)
  gives the monolithic output pass's pixels on the same centroids (one
  thread: ROADMAP C's multithreaded near-tie class), trains the
  reference's centroids and gives at least 99.99% of the reference's
  pixels; each condition of the reference's gate, when it fails, leaves
  `reduce` on the default path, bit for bit;
- phases timed on the banded path's worker threads reach the caller's
  `collect_phases` block (`api._submit`), and `recording()` is the
  reference's.

Five reference calls run JAX (two palettes, one training, two reduces);
the reference's `warmup` count is taken with its entry points stubbed.
"""

import math

import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu.ops.resize import resize_uint8_np as ref_resize_uint8_np
import kmeans_tpu_torch as kt
from kmeans_tpu_torch.api import PIPELINE_BAND_ROWS, _lab_palette_to_u8
from kmeans_tpu_torch.ops.resize import resize_uint8_np

torch.set_num_threads(2)

TALL_H, TALL_W = 2100, 64  # 5 bands of 512 rows, the last of 52
K = 4


def _blobs(h, w, seed=91):
    """Four noisy colour blobs (tests/test_api.py:416-426), RGBA8."""
    rng = np.random.default_rng(seed)
    base = np.array([[230, 40, 40], [40, 220, 60], [60, 60, 230], [240, 240, 30]], np.int32)
    idx = rng.integers(0, 4, (h, w))
    rgb = np.clip(base[idx] + rng.integers(-10, 11, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


@pytest.fixture(scope="module")
def blobs():
    rgba = _blobs(700, 520)
    return rgba, [rgba, rgba[::-1].copy()]


@pytest.fixture(scope="module")
def tall():
    return _blobs(TALL_H, TALL_W, seed=92)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spy(monkeypatch, name):
    """Record each call of `ImageProcessor.<name>` as its positional
    arguments after `self`."""
    calls = []
    inner = getattr(kt.ImageProcessor, name)

    def spy(self, *args, **kwargs):
        calls.append(args)
        return inner(self, *args, **kwargs)

    monkeypatch.setattr(kt.ImageProcessor, name, spy)
    return calls


@pytest.mark.parametrize("h,w,nh,nw", [
    (2100, 640, 144, 256),  # the reference test's tall image
    (2160, 3840, 144, 256),  # 4K to its training strip
    (37, 53, 20, 11),  # odd sizes
    (60, 50, 60, 50),  # no shrink: the same-size resample (not the identity)
    (9, 7, 20, 30),  # a stretch
])
def test_resize_uint8_np_gives_the_reference_bytes(h, w, nh, nw):
    rgba = np.random.default_rng(h * w).integers(0, 256, (h, w, 4), dtype=np.uint8)
    want = ref_resize_uint8_np(np.ascontiguousarray(rgba[..., :3]), nh, nw)
    got = resize_uint8_np(rgba[..., :3], nh, nw)
    assert got.shape == (nh, nw, 3) and got.dtype == np.uint8
    assert int((got != want).sum()) == 0
    # Channels are independent: the RGBA strip's colour is the RGB strip.
    np.testing.assert_array_equal(resize_uint8_np(rgba, nh, nw)[..., :3], want)


def test_pipelined_palettes_match_reference(blobs, monkeypatch):
    """`palette` and `palette_images` against the reference's under
    pipeline mode: the same strip bytes train the same trainer. Only the
    strips upload (256 x 190 x 3 bytes each)."""
    rgba, frames = blobs
    uploads = _spy(monkeypatch, "_upload")
    port = kt.ImageProcessor(device="cpu", pipeline=True)
    ref = kmeans_tpu.ImageProcessor(pipeline=True)
    np.testing.assert_array_equal(port.palette(K, rgba), ref.palette(K, rgba))
    assert [a[0].shape for a in uploads] == [(256, 190, 3)]
    uploads.clear()
    np.testing.assert_array_equal(port.palette_images(frames, K), ref.palette_images(frames, K))
    assert [a[0].shape for a in uploads] == [(2, 256, 190, 3)]


@pytest.mark.parametrize("case", [
    "no_shrink", "octree", "mediancut", "wu", "bucketed", "bucketed_images", "many",
])
def test_pipelined_palette_family_matches_default(blobs, case, monkeypatch):
    """Each member of the palette family under pipeline mode equals the
    port's default path (the reference asserts the same of its own,
    tests/test_api.py:427-455), and moves only the strips: the host
    algorithms upload nothing, the bucketed trainings the strip (RGBA,
    padded on the device to the strip's bucket)."""
    rgba, frames = blobs
    kwargs = {"train_max_size": 1024} if case == "no_shrink" else {}
    kwargs["bucketing"] = case in ("bucketed", "bucketed_images", "many")
    piped = kt.ImageProcessor(device="cpu", pipeline=True, **kwargs)
    plain = kt.ImageProcessor(device="cpu", **kwargs)
    if case in ("octree", "mediancut", "wu"):
        algo = kt.Algorithm[case.upper()]
        want = plain.palette(K, rgba, algo), plain.palette_images(frames, K, algo)
        uploads = _spy(monkeypatch, "_upload_image")
        np.testing.assert_array_equal(piped.palette(K, rgba, algo), want[0])
        np.testing.assert_array_equal(piped.palette_images(frames, K, algo), want[1])
        assert uploads == []
        return
    if case == "many":
        images = [rgba, frames[1], rgba[:690, :515].copy(), _blobs(120, 90, seed=7)]
        want = plain.palette_many(images, K)
        trained = _spy(monkeypatch, "_train_bucketed_frames")
        got = piped.palette_many(images, K)
        # The three big images' strips share a strip bucket: one batched training.
        assert [a[0].shape for a in trained] == [(3, 256, 192, 3)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    want = (plain.palette_images(frames, K) if case == "bucketed_images"
            else plain.palette(K, rgba))
    padded = _spy(monkeypatch, "_upload_padded")
    got = (piped.palette_images(frames, K) if case == "bucketed_images"
           else piped.palette(K, rgba))
    np.testing.assert_array_equal(got, want)
    if kwargs["bucketing"]:
        assert [[f.pixels.shape for f in a[0]] for a in padded] == [
            [(256, 190, 4)] * (2 if case == "bucketed_images" else 1)]


@pytest.mark.parametrize("pipeline", [False, True])
def test_pipelined_warmup_count_matches_reference(pipeline):
    """`warmup` keys the palette dummies by the strip's bucket under
    pipeline mode: 1280x720 and 1300x730 fill two image buckets but one
    strip bucket at a 64-px cap. Its count is the reference's, with the
    reference's entry points stubbed (the count depends only on the
    keys), with and without pipeline mode."""
    args = ([(700, 520), (1280, 720), (1300, 730)], [2, 3])
    kwargs = {"gif_frame_counts": [2], "batch_sizes": [2]}
    ref = kmeans_tpu.ImageProcessor(bucketing=True, pipeline=pipeline, train_max_size=64)
    for name in ("reduce", "palette", "find", "palette_images", "reduce_images", "reduce_many",
                 "palette_many", "find_batch", "find_many"):
        setattr(ref, name, lambda *a, **k: None)
    want = ref.warmup(*args, **kwargs)
    assert want == (15 if pipeline else 18)
    port = kt.ImageProcessor(device="cpu", bucketing=True, pipeline=pipeline, train_max_size=64)
    assert port.warmup(*args, **kwargs) == want


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER"])
def test_banded_reduce_matches_monolithic_pass(tall, mode, monkeypatch, one_thread):
    """The banded `reduce` launches one output pass a band, each with its
    first row as `row_offset`, and gives the monolithic pass's pixels on the
    same centroids (those `extract_palette_kmeans` trains on the strip)."""
    proc = kt.ImageProcessor(device="cpu", pipeline=True)
    mode = kt.ReduceMode[mode]
    passes = _spy(monkeypatch, "_output_pass")
    got = proc.reduce(K, tall, reduce_mode=mode).pixels
    bands = math.ceil(TALL_H / PIPELINE_BAND_ROWS)
    assert bands == 5 and len(passes) == bands
    assert [a[4] for a in passes] == list(range(0, TALL_H, PIPELINE_BAND_ROWS))
    assert [a[0].shape[0] for a in passes] == [512] * 4 + [52]
    assert proc.last_iterations >= 1
    passes.clear()
    cents = proc.extract_palette_kmeans(kt.Image((TALL_W, TALL_H), tall), K)
    want = proc._quantize(proc._upload(np.ascontiguousarray(tall[..., :3])), cents, mode.value)
    assert len(passes) == 1
    assert got.shape == (TALL_H, TALL_W, 4) and (got[..., 3] == 255).all()
    assert int((got != want).any(-1).sum()) == 0


def test_banded_reduce_matches_reference(tall):
    """The banded path trains the reference's pipeline centroids on the
    strip, and its pixels are the reference's `reduce` (on the CPU the
    reference takes its monolithic pass, `self.fused` false) at its own
    bar, >= 99.99% (tests/test_api.py:396)."""
    ref = kmeans_tpu.ImageProcessor(pipeline=True)
    proc = kt.ImageProcessor(device="cpu", pipeline=True)
    image = kt.Image((TALL_W, TALL_H), tall)
    want = np.asarray(ref.extract_palette_kmeans(kmeans_tpu.Image((TALL_W, TALL_H), tall), K))
    cents = proc.extract_palette_kmeans(image, K)
    np.testing.assert_allclose(cents.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_lab_palette_to_u8(cents)[0].numpy(),
                                  _lab_palette_to_u8(torch.tensor(want))[0].numpy())
    for mode in ("REPLACE", "DITHER"):
        got = proc.reduce(K, tall, reduce_mode=kt.ReduceMode[mode]).pixels
        ref_px = ref.reduce(K, tall, reduce_mode=kmeans_tpu.ReduceMode[mode]).pixels
        assert (got == ref_px).all(-1).mean() >= 0.9999, mode


@pytest.mark.parametrize("case", ["h2047", "meld", "k1025", "bucketing", "full_resolution"])
def test_banded_gate_negatives_take_the_default_path(tall, case, monkeypatch, one_thread):
    """Each condition of the gate (kmeans_tpu/api.py:1437-1447) that fails
    leaves `reduce` on the default path: bit for bit the output of a
    processor without pipeline mode."""
    kwargs, k, mode, img = {}, K, kt.ReduceMode.REPLACE, tall
    if case == "h2047":
        img = tall[:PIPELINE_BAND_ROWS * 4 - 1]
    elif case == "meld":
        mode = kt.ReduceMode.MELD
    elif case == "k1025":
        k, img = 1025, tall[:, :8]
    elif case == "bucketing":
        kwargs["bucketing"] = True
    else:
        kwargs["train_max_size"] = None
    img = np.ascontiguousarray(img)
    want = kt.ImageProcessor(device="cpu", **kwargs).reduce(k, img, reduce_mode=mode).pixels

    def refuse(*_):
        raise AssertionError("the banded path was taken")

    monkeypatch.setattr(kt.ImageProcessor, "_reduce_banded", refuse)
    got = kt.ImageProcessor(device="cpu", pipeline=True, **kwargs).reduce(k, img,
                                                                          reduce_mode=mode)
    np.testing.assert_array_equal(got.pixels, want)


def test_phases_of_worker_threads_are_recorded():
    """`utils/profiling.py`: `recording()` says whether a `collect_phases`
    block is open, as the reference's does; a phase timed on a worker
    thread that `api._submit` started lands in the caller's block (a plain
    `submit` runs outside it), and concurrent adds lose nothing."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from kmeans_tpu.utils import profiling as ref_profiling
    from kmeans_tpu_torch.api import _submit
    from kmeans_tpu_torch.utils import profiling

    def work(name):
        with profiling.phase(name):
            pass

    def count(acc):
        for _ in range(2000):
            profiling._add(acc, "n", 1)

    assert profiling.recording() is ref_profiling.recording() is False
    phases: dict = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.collect_phases(phases), ref_profiling.collect_phases({}):
            assert profiling.recording() is ref_profiling.recording() is True
            with ThreadPoolExecutor(16) as pool:
                _submit(pool, work, "worker").result(timeout=60)
                pool.submit(work, "outside").result(timeout=60)
                for done in [_submit(pool, count, phases) for _ in range(16)]:
                    done.result(timeout=60)
            _submit(None, work, "inline").result()
    finally:
        sys.setswitchinterval(interval)
    assert profiling.recording() is False
    assert sorted(phases) == ["inline", "n", "worker"] and phases["n"] == 16 * 2000
