"""Multi-device sharding (`kmeans_tpu_torch/parallel/`) against the JAX package's.

The port's meshes here are `["cpu"] * D` for D in 1..8: one process, each
shard's tensors on the CPU, the real D-shard code. The reference runs its
sharded functions on its 8 virtual CPU devices (`tests/conftest.py`): its
`fit_sharded`, `find_sharded` and `make_mesh`, its unpacks and its trainer
route, each run once and every port mesh held against them with the
reference's own bars (`tests/test_distributed.py`): centroids within 1e-3
and equal iteration counts, the output passes bit for bit. Reference
trainings cost 10-15 s of XLA compilation each, so the entry points are
held to the port's single-device calls (which the other port files hold to
the reference's) with the reference's bars: palettes within 2 u8, at least
0.999 of the pixels equal (0.99 where the reference holds its bucketed and
batched calls to that); a one-shard mesh gives their bits, and the seeds
are `plusplus_init`'s on every shard count.
"""

import jax
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu.api as ref_api
import kmeans_tpu_torch as kt
from kmeans_tpu.parallel import distributed as ref_dist
from kmeans_tpu.parallel import mesh as ref_mesh
from kmeans_tpu.parallel import sharded_ops as ref_ops
from kmeans_tpu_torch import api
from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.quantize import dither_threshold
from kmeans_tpu_torch.parallel import Mesh, make_mesh
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.parallel.collectives import psum
from kmeans_tpu_torch.parallel.sharded_ops import (
    _assign_words,
    _meld_words,
    _row_sharded,
    assign_fused_sharded,
    assign_indexed_sharded,
    meld_fused_sharded,
    unpack_fused_sharded,
    unpack_meld_sharded,
)
from kmeans_tpu_torch.utils.packing import pack_bits, unpack_tile_words

torch.set_num_threads(2)

SHARDS = (1, 2, 4, 8)


def _cpu_mesh(d, data=1):
    return make_mesh(["cpu"] * d, data=data)


def _blob_pixels(n=4096, seed=0):
    """tests/test_distributed.py:17-23."""
    rng = np.random.default_rng(seed)
    centers = np.array([[20.0, 0.0, 0.0], [60.0, 40.0, -30.0], [90.0, -50.0, 50.0]])
    return (centers[rng.integers(0, 3, n)] + rng.normal(0, 0.5, (n, 3))).astype(np.float32)


def _blob_rgba(seed, shape=(64, 96)):
    """tests/test_distributed.py:392-399."""
    base = np.array([[230, 40, 40], [40, 220, 60], [60, 60, 230]], np.int32)
    r = np.random.default_rng(seed)
    idx = r.integers(0, 3, size=shape)
    rgb = np.clip(base[idx] + r.integers(-10, 11, idx.shape + (3,)), 0, 255)
    return np.concatenate([rgb.astype(np.uint8), np.full(shape + (1,), 255, np.uint8)], -1)


def _padded(pts, d):
    """`pts` padded with zero rows of weight 0 to a multiple of `d`."""
    n = pts.shape[0]
    n_pad = -(-n // d) * d
    px = torch.from_numpy(np.concatenate([pts, np.zeros((n_pad - n, 3), np.float32)]))
    return px, (torch.arange(n_pad) < n).to(torch.float32)


def _equal_share(a, b):
    return float((np.asarray(a) == np.asarray(b)).all(-1).mean())


def _palette_step(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.fixture(scope="module")
def ref_mesh8():
    return ref_mesh.make_mesh(jax.devices(), data=1)


@pytest.fixture(scope="module")
def ref_fit(ref_mesh8):
    """The reference's one-hot `fit_sharded` on its 8-device mesh, run once
    (10-15 s of XLA compilation on one core: the file's only reference
    training, as `tests/test_distributed.py` sets Tier-1's wall clock). The
    entry points are held to the port's single-device calls, which
    `tests/test_torch_api.py` and the other port files hold to the
    reference's, and their output passes to the reference's `find_sharded`."""
    import jax.numpy as jnp

    pts = _blob_pixels()
    cents, iters = ref_dist.fit_sharded(ref_mesh8, jnp.asarray(pts),
                                        jnp.ones(pts.shape[0], jnp.float32), 3, 0)
    return np.asarray(cents), int(iters)


# --- The mesh ---------------------------------------------------------------


@pytest.mark.parametrize("n,data,pixel", [
    (8, 1, None), (8, 2, None), (8, 4, None), (8, 2, 4), (8, 8, 1), (4, 1, None), (1, 1, None),
    (8, 3, None), (8, 2, 3), (6, 4, None), (4, 1, 2),
])
def test_make_mesh_shapes_and_errors(n, data, pixel):
    """The port's mesh has the reference's axes and shape, and raises where
    the reference raises (kmeans_tpu/parallel/mesh.py:26)."""
    try:
        want = ref_mesh.make_mesh(jax.devices()[:n], data=data, pixel=pixel)
    except ValueError:
        with pytest.raises(ValueError):
            make_mesh(["cpu"] * n, data=data, pixel=pixel)
        return
    got = make_mesh(["cpu"] * n, data=data, pixel=pixel)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert got.root == torch.device("cpu")


def test_mesh_refuses_mixed_or_missing_devices():
    """No mesh mixes device types or names CUDA without a card, and a
    processor refuses a mesh of the other device type: nothing moves to
    the CPU quietly."""
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(["meta"])
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA"):
        make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError):
        make_mesh()
    cuda_mesh = Mesh(np.array([[torch.device("cuda", 0)]], dtype=object))
    port = kt.ImageProcessor(device="cpu")
    with pytest.raises(ValueError, match="processor"):
        port.find_sharded(_blob_rgba(1, (8, 8)), [[0, 0, 0]], mesh=cuda_mesh)
    out = port.find_sharded(_blob_rgba(1, (8, 8)), [[0, 0, 0]])  # mesh=None: the CPU alone
    assert (out.pixels == [0, 0, 0, 255]).all()


# --- fit_sharded --------------------------------------------------------------


@pytest.mark.parametrize("d", SHARDS)
def test_fit_sharded_onehot_matches_reference(ref_fit, d):
    """The one-hot trainer against the reference's on its 8-device mesh
    (tests/test_distributed.py:26): atol 1e-3, the same iterations; and
    against the port's single-device `fit` bit for bit (the shards'
    float64 partials add before one rounding)."""
    pts = _blob_pixels()
    got, iters = dist.fit_sharded(_cpu_mesh(d), torch.from_numpy(pts),
                                  torch.ones(pts.shape[0]), 3, 0)
    want, want_iters = ref_fit
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert iters == want_iters
    single, single_iters = km.fit(torch.from_numpy(pts), 3, 0)
    assert torch.equal(got, single) and iters == single_iters


@pytest.mark.parametrize("d", [3, 8, 12])
def test_fit_sharded_with_padding(d):
    """4000 pixels pad to the shard count with 0-weight rows
    (tests/test_distributed.py:38): the centroids of the unpadded fit."""
    pts = _blob_pixels(n=4000)
    px, w = _padded(pts, d)
    got, iters = dist.fit_sharded(_cpu_mesh(d), px, w, 3, 0)
    want, want_iters = km.fit(torch.from_numpy(pts), 3, 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
    assert iters == want_iters


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("k,k_active,metric", [(8, None, "cie94"), (8, 5, "cie94"),
                                               (3, None, "cie2000")])
def test_sharded_seeds_equal_single_device(d, k, k_active, metric):
    """Farthest-point seeding over the shards gives `plusplus_init`'s seeds
    bit for bit, padded or not (a selection: no sum to reorder)."""
    rng = np.random.default_rng(d + k)
    pts = np.concatenate([_blob_pixels(n=1500, seed=d),
                          rng.normal(50, 30, (501, 3)).astype(np.float32)])
    px, w = _padded(pts, d)
    first = 1234
    got = dist.seed_sharded(_cpu_mesh(d), px, w, k, first, k_active, metric)
    want = km.plusplus_init(torch.from_numpy(pts), k, first, k_active, metric)
    assert torch.equal(got, want)


@pytest.mark.parametrize("trainer,single", [
    ("onehot", lambda p, k, f, **kw: km.fit(p, k, f, **kw)),
    ("pallas", lambda p, k, f, **kw: km.fit_large(p, k, f, **kw)),
    ("chunked", lambda p, k, f, **kw: km.fit_chunked(p, k, f, **kw)),
])
def test_one_shard_mesh_equals_single_device(trainer, single):
    """A one-shard mesh trains as the single-device trainer of its route,
    bit for bit."""
    pts = torch.from_numpy(_blob_pixels(n=3000, seed=4))
    got, iters = dist.fit_sharded(_cpu_mesh(1), pts, None, 4, 11, k_active=3, trainer=trainer)
    want, want_iters = single(pts, 4, 11, k_active=3)
    assert torch.equal(got, want) and iters == want_iters


@pytest.mark.parametrize("trainer,single", [
    ("pallas", km.fit_large), ("chunked", lambda p, k, f: km.fit_chunked(p, k, f)),
])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_fit_sharded_large_routes_match_single_device(trainer, single, d):
    """The accumulator and row-chunked trainers against the port's
    `fit_large` / `fit_chunked` (tests/test_distributed.py:183, 252): atol
    1e-3, the same iterations."""
    pts = torch.from_numpy(_blob_pixels(seed=3))
    got, iters = dist.fit_sharded(_cpu_mesh(d), pts, None, 3, 0, trainer=trainer)
    want, want_iters = single(pts, 3, 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
    assert iters == want_iters


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_accumulator_counts_exact_sums_close(d):
    """Given the same centroids, the shards' accumulator totals added in
    shard order give the single pass's counts exactly and its sums within
    1e-5 (tests/test_distributed.py:202)."""
    pts = torch.from_numpy(_blob_pixels(n=8192, seed=11))
    cents, _ = km.fit(pts, 4, 0)
    planes, n_valid = kernels.pack_lab_planes(pts)
    want = kernels.lloyd_accumulate(planes, cents, n_valid,
                                    weight_planes=kernels.pack_plane(torch.ones(8192)))
    parts = []
    for block in torch.split(pts, 8192 // d):
        pl, nv = kernels.pack_lab_planes(block)
        parts.append(kernels.lloyd_accumulate(pl, cents, nv,
                                              weight_planes=kernels.pack_plane(
                                                  torch.ones(block.shape[0]))))
    got = psum(parts, torch.device("cpu"))
    assert torch.equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, :3].numpy(), want[:, :3].numpy(), rtol=1e-5)


@pytest.mark.parametrize("trainer,single", [
    ("onehot", km.fit_restarts), ("pallas", km.fit_large_restarts), ("chunked", km.fit_chunked),
])
def test_fit_sharded_restarts_pick_least_inertia(trainer, single):
    """With restarts the run of least psum'd inertia wins: equal to the
    individually run sharded fit of the winning seed, and within 1e-3 of
    the single-device restarts (tests/test_distributed.py:146, 269, 302)."""
    pts = torch.from_numpy(_blob_pixels(seed=7))
    mesh = _cpu_mesh(4)
    got, iters = dist.fit_sharded(mesh, pts, None, 3, 0, restarts=3, trainer=trainer)
    seeds = km.derive_restart_seeds(pts.shape[0], 0, 3).tolist()
    runs = [dist.fit_sharded(mesh, pts, None, 3, s, trainer=trainer) for s in seeds]
    valid = torch.ones(3, dtype=torch.bool)
    best = int(np.argmin([float(km._sum_min_d2(pts, c, valid, "cie94")) for c, _ in runs]))
    assert torch.equal(got, runs[best][0]) and iters == runs[best][1]
    want, want_iters = single(pts, 3, 0, restarts=3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
    assert iters == want_iters


def test_fit_sharded_pallas_bf16_planes():
    """`plane_dtype="bfloat16"` reaches the sharded accumulator's planes:
    it runs and stays near the float32 planes (tests/test_distributed.py:290)."""
    pts = torch.from_numpy(_blob_pixels(seed=21))
    mesh = _cpu_mesh(4)
    bf16, _ = dist.fit_sharded(mesh, pts, None, 3, 0, trainer="pallas", plane_dtype="bfloat16")
    f32, _ = dist.fit_sharded(mesh, pts, None, 3, 0, trainer="pallas")
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), atol=0.5)


@pytest.mark.parametrize("call", ["fit_sharded", "fit_sharded_batch"])
def test_fit_sharded_rejects_unknown_trainer(call):
    """tests/test_distributed.py:137."""
    with pytest.raises(ValueError, match="unknown trainer"):
        if call == "fit_sharded":
            dist.fit_sharded(_cpu_mesh(2), torch.zeros(64, 3), None, 3, 0, trainer="nope")
        else:
            dist.fit_sharded_batch(_cpu_mesh(8, data=2), torch.zeros(2, 64, 3), None, 3, 0,
                                   [3, 3], trainer="nope")


# --- The trainer route ----------------------------------------------------------


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
@pytest.mark.parametrize("fast", [False, True])
def test_sharded_trainer_route_mirrors_reference(metric, fast):
    """The port's `_sharded_trainer_route` gives the reference's route
    (kmeans_tpu/api.py:294) with its accumulator available, as the port's
    `_fit_auto` reads it, over a grid of pixel counts and palette sizes,
    whatever the metric and `fast`."""
    for n_px in (65_536, 1 << 20, (1 << 20) + 1, 384_000, 8_294_400):
        for kp in (1, 8, 64, 65, 128, 256, 512, 513, 600, 1024):
            assert (api._sharded_trainer_route(n_px, kp)
                    == ref_api._sharded_trainer_route(n_px, kp, True, metric, fast=fast)
                    ), (n_px, kp)


# --- fit_sharded_batch ----------------------------------------------------------


@pytest.mark.parametrize("trainer", ["onehot", "pallas", "chunked"])
@pytest.mark.parametrize("restarts", [1, 2])
def test_fit_sharded_batch_matches_per_frame(trainer, restarts):
    """Frames over the data axis of a 2x4 mesh, each with its own k_active:
    each frame equals `fit_sharded` on a 4-wide pixel axis, bit for bit
    (tests/test_distributed.py:74, 111)."""
    pts = _blob_pixels(seed=5)
    batch = torch.from_numpy(np.stack([pts, pts[::-1].copy()]))
    got = dist.fit_sharded_batch(_cpu_mesh(8, data=2), batch, None, 4, [0, 9], [3, 4],
                                 restarts=restarts, trainer=trainer)
    assert got.shape == (2, 4, 3)
    for b, (first, ka) in enumerate(((0, 3), (9, 4))):
        want, _ = dist.fit_sharded(_cpu_mesh(4), batch[b], None, 4, first, k_active=ka,
                                   restarts=restarts, trainer=trainer)
        assert torch.equal(got[b], want)


# --- The output passes ------------------------------------------------------------


@pytest.fixture(scope="module")
def find_case():
    """tests/test_distributed.py:686: 63x80 (odd height), 3 colours, the
    reference's `find_sharded` on its 8-device mesh in three modes."""
    rng = np.random.default_rng(8)
    rgba = rng.integers(0, 256, (63, 80, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    colors = np.array([[5, 5, 5, 255], [250, 250, 250, 255], [200, 30, 30, 255]], np.uint8)
    ref = kmeans_tpu.ImageProcessor()
    want = {m: ref.find_sharded(rgba, colors, kmeans_tpu.ReduceMode(m)).pixels
            for m in ("replace", "dither", "meld")}
    return rgba, colors, want


@pytest.mark.parametrize("d", range(1, 9))
@pytest.mark.parametrize("mode", ["replace", "dither", "meld"])
def test_find_sharded_matches_reference(find_case, d, mode):
    """`find_sharded` on 1-8 shards equals the reference's `find_sharded`
    and the port's `find`, bit for bit."""
    rgba, colors, want = find_case
    port = kt.ImageProcessor(device="cpu")
    got = port.find_sharded(rgba, colors, kt.ReduceMode(mode), mesh=_cpu_mesh(d)).pixels
    np.testing.assert_array_equal(got, want[mode])
    np.testing.assert_array_equal(got, port.find(rgba, colors, kt.ReduceMode(mode)).pixels)


@pytest.mark.parametrize("d,mode", [(2, "replace"), (3, "dither")])
def test_find_sharded_colour_out(d, mode):
    """Past `INDEXED_MAX_K` colours each shard runs the colour-out pass with
    its `row_offset`: `find`'s pixels."""
    rng = np.random.default_rng(d)
    rgba = _blob_rgba(d, (13, 37))
    colors = rng.integers(0, 256, (1100, 3), dtype=np.uint8)
    port = kt.ImageProcessor(device="cpu")
    got = port.find_sharded(rgba, colors, kt.ReduceMode(mode), mesh=_cpu_mesh(d)).pixels
    np.testing.assert_array_equal(got, port.find(rgba, colors, kt.ReduceMode(mode)).pixels)


@pytest.mark.parametrize("d", [2, 3, 8])
@pytest.mark.parametrize("k", [3, 16, 40])
def test_shard_words_are_the_whole_images_rows(d, k):
    """Each shard's dither words, unpacked, are its rows of the whole
    image's index map: the `row_offset = s * local_h` keeps the Bayer
    phase, which the shard would lose without it."""
    rgb = torch.from_numpy(np.ascontiguousarray(_blob_rgba(k, (53, 41))[..., :3]))
    cents = torch.from_numpy(np.random.default_rng(k).normal(50, 30, (k, 3)).astype(np.float32))
    thr = dither_threshold(cents)
    blocks, h, local_h = _row_sharded(_cpu_mesh(d), rgb)
    words = _assign_words(blocks, local_h, cents, "dither", None, "cie94", False)
    bits, tiles = pack_bits(k), kernels.quant_tile_rows(k)
    whole = unpack_tile_words(kernels.assign_packed_reference(rgb, cents, thr, mode="dither")
                              .numpy(), h, 41, bits, tiles)
    for s, (block, wd) in enumerate(zip(blocks, words)):
        np.testing.assert_array_equal(unpack_tile_words(wd.numpy(), local_h, 41, bits, tiles)
                                      [:max(0, min(local_h, h - s * local_h))],
                                      whole[s * local_h:(s + 1) * local_h])
        assert torch.equal(wd, kernels.assign_packed_reference(block, cents, thr, mode="dither",
                                                               row_offset=s * local_h))
    # Shard 1 without its offset dithers with another phase.
    off = unpack_tile_words(kernels.assign_packed_reference(blocks[1], cents, thr,
                                                            mode="dither").numpy(),
                            local_h, 41, bits, tiles)
    if local_h % 4:
        assert not np.array_equal(off[:h - local_h], whole[local_h:2 * local_h])


@pytest.mark.parametrize("d", [2, 5, 8])
def test_unpack_helpers_match_reference(d):
    """The port's sharded words and unpacks against the reference's unpack
    helpers on the same words (kmeans_tpu/parallel/sharded_ops.py:259,
    283), and `assign_indexed_sharded`'s index map."""
    rgba = _blob_rgba(40 + d, (61, 70))
    cents = torch.from_numpy(np.random.default_rng(d).normal(50, 30, (5, 3)).astype(np.float32))
    mesh = _cpu_mesh(d)
    words, bits = assign_fused_sharded(mesh, rgba, cents, "dither")
    want = ref_ops.unpack_fused_sharded(words, 61, 70, 5, d)
    np.testing.assert_array_equal(unpack_fused_sharded(words, 61, 70, 5, d), want)
    idx, idx_bits = assign_indexed_sharded(mesh, rgba, cents, "dither")
    np.testing.assert_array_equal(idx, want)
    assert bits == idx_bits == 4
    meld = meld_fused_sharded(mesh, rgba, cents)
    np.testing.assert_array_equal(unpack_meld_sharded(meld, 61, 70, 5, d),
                                  ref_ops.unpack_meld_sharded(meld, 61, 70, 5, d))
    blocks, _, _ = _row_sharded(mesh, rgba)
    assert len(_meld_words(blocks, cents, None, "cie94", False)) == d


# --- The entry points against the reference's ---------------------------------------


@pytest.mark.parametrize("d", SHARDS)
def test_reduce_and_palette_sharded_match_single_device(d):
    """`reduce_sharded` 96x120 k=3 (tests/test_distributed.py:667) gives
    the port's `reduce` pixels (the reference's bar is 0.999 against its
    own; here the shards' float64 partials keep every bit), and
    `palette_sharded` is within 2 u8 of `palette` (equal here)."""
    img = _blob_rgba(7, (96, 120))
    port = kt.ImageProcessor(device="cpu")
    mesh = _cpu_mesh(d)
    np.testing.assert_array_equal(port.reduce_sharded(3, img, mesh=mesh).pixels,
                                  port.reduce(3, img).pixels)
    pal = port.palette_sharded(3, img, mesh=mesh)
    assert _palette_step(pal, port.palette(3, img)) <= 2
    assert len(np.unique(pal, axis=0)) == 3


@pytest.mark.parametrize("d", [1, 2, 8])
def test_reduce_sharded_bucketed(d):
    """Bucketed `reduce_sharded` of 75x101 (tests/test_distributed.py:721):
    the output crops to the image, holds at most k colours and equals the
    port's bucketed `reduce` (bit for bit on one shard; the reference's
    0.99 bar on more)."""
    img = _blob_rgba(10, (75, 101))
    port = kt.ImageProcessor(device="cpu", bucketing=True)
    got = port.reduce_sharded(3, img, mesh=_cpu_mesh(d))
    assert got.dimensions == (101, 75)
    assert len(np.unique(got.pixels.reshape(-1, 4), axis=0)) <= 3
    single = port.reduce(3, img).pixels
    assert _equal_share(got.pixels, single) >= 0.99
    if d == 1:
        np.testing.assert_array_equal(got.pixels, single)


@pytest.mark.parametrize("data,pixel", [(2, 4), (2, 1), (1, 2)])
def test_reduce_images_sharded_matches_per_frame(data, pixel):
    """`reduce_images_sharded` of 2 frames at k=4, dither: each frame equals
    its `reduce_sharded` on its data row's pixel axis, bit for bit, and at
    least 0.99 of its pixels equal `reduce_images`'
    (tests/test_distributed.py:405)."""
    frames = [_blob_rgba(21), _blob_rgba(22)]
    port = kt.ImageProcessor(device="cpu")
    outs = port.reduce_images_sharded(frames, 4, kt.ReduceMode.DITHER,
                                      mesh=_cpu_mesh(data * pixel, data=data))
    assert len(outs) == 2
    for frame, out, want in zip(frames, outs,
                                port.reduce_images(frames, 4, kt.ReduceMode.DITHER)):
        assert _equal_share(out.pixels, want.pixels) >= 0.99
        np.testing.assert_array_equal(
            out.pixels, port.reduce_sharded(4, frame, kt.ReduceMode.DITHER,
                                            mesh=_cpu_mesh(pixel)).pixels)


@pytest.mark.parametrize("bucketing", [False, True])
def test_reduce_images_sharded_pads_the_batch(bucketing):
    """3 frames on a data axis of 2 pad with frame 0, whose output is
    dropped; each frame equals its `reduce_sharded`."""
    frames = [_blob_rgba(s, (40, 52)) for s in (11, 12, 13)]
    port = kt.ImageProcessor(device="cpu", bucketing=bucketing)
    outs = port.reduce_images_sharded(frames, 3, mesh=_cpu_mesh(4, data=2))
    assert len(outs) == 3
    for frame, out in zip(frames, outs):
        assert out.pixels.shape == frame.shape
        np.testing.assert_array_equal(out.pixels,
                                      port.reduce_sharded(3, frame, mesh=_cpu_mesh(2)).pixels)


@pytest.mark.parametrize("d", SHARDS)
def test_palette_images_sharded_matches_palette_images(d):
    """The joint palette of 3 frames within 2 u8 of `palette_images`
    (tests/test_distributed.py:741); one shard gives its bits."""
    frames = [_blob_rgba(21), _blob_rgba(22), _blob_rgba(23)]
    port = kt.ImageProcessor(device="cpu")
    got = port.palette_images_sharded(frames, 4, mesh=_cpu_mesh(d))
    want = port.palette_images(frames, 4)
    assert _palette_step(got, want) <= 2
    if d == 1:
        np.testing.assert_array_equal(got, want)


def test_palette_images_sharded_host_algorithm_falls_back(ref_mesh8):
    """A host algorithm runs `palette_images` (kmeans_tpu/api.py:2391): the
    reference's octree palette, and the port's `palette_images`."""
    frames = [_blob_rgba(21), _blob_rgba(22)]
    port = kt.ImageProcessor(device="cpu")
    got = port.palette_images_sharded(frames, 4, kt.Algorithm.OCTREE, mesh=_cpu_mesh(8))
    np.testing.assert_array_equal(got, port.palette_images(frames, 4, kt.Algorithm.OCTREE))
    np.testing.assert_array_equal(got, kmeans_tpu.ImageProcessor().palette_images_sharded(
        frames, 4, kmeans_tpu.Algorithm.OCTREE, mesh=ref_mesh8))


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("mode", ["replace", "dither", "meld"])
def test_find_batch_sharded_matches_find_batch(d, mode):
    """Frames of 39 rows (padded to 40 in the tall stack, so each keeps its
    Bayer phase) equal the port's `find_batch` and each frame's `find`, bit
    for bit (tests/test_distributed.py:789, 812)."""
    frames = [_blob_rgba(s, (39, 52)) for s in (31, 32, 33)]
    colors = np.array([[5, 5, 5, 255], [255, 255, 255, 255], [255, 0, 0, 255]], np.uint8)
    port = kt.ImageProcessor(device="cpu")
    outs = port.find_batch_sharded(frames, colors, kt.ReduceMode(mode), mesh=_cpu_mesh(d))
    for out, want, frame in zip(outs, port.find_batch(frames, colors, kt.ReduceMode(mode)),
                                frames):
        np.testing.assert_array_equal(out.pixels, want.pixels)
        np.testing.assert_array_equal(out.pixels,
                                      port.find(frame, colors, kt.ReduceMode(mode)).pixels)


@pytest.mark.parametrize("route,knob,k", [("pallas", "_LARGE_TRAIN_PIXELS", 8),
                                          ("pallas", "_CHUNKED_TRAIN_ELEMS", 65),
                                          ("chunked", "_CHUNKED_TRAIN_ELEMS", 513)])
def test_full_resolution_sharded_training_routes(monkeypatch, route, knob, k):
    """With `train_max_size=None` and the size gates lowered, the sharded
    trainings take the large-N routes (tests/test_distributed.py:360, 444,
    761), routed by the real (concatenated) pixel count; a one-shard mesh
    gives the single-device `palette` bit for bit, 4 shards within 2 u8."""
    monkeypatch.setattr(api, knob, 1)
    routes = []
    real = api._sharded_trainer_route

    def spy(n_px, kp):
        routes.append((n_px, real(n_px, kp)))
        return routes[-1][1]

    monkeypatch.setattr(api, "_sharded_trainer_route", spy)
    img = _blob_rgba(17, (48, 60))
    port = kt.ImageProcessor(device="cpu", train_max_size=None)
    single = port.palette(k, img)
    np.testing.assert_array_equal(port.palette_sharded(k, img, mesh=_cpu_mesh(1)), single)
    assert _palette_step(port.palette_sharded(k, img, mesh=_cpu_mesh(4)), single) <= 2
    port.palette_images_sharded([img, img], k, mesh=_cpu_mesh(2))
    assert routes == [(48 * 60, route)] * 2 + [(2 * 48 * 60, route)]
