"""Farthest-point seeding at exact ties (ROADMAP C.7).

When k exceeds the distinct colours of the training pixels, every entry of
the seeding's distance map ends at 0 but one: the JAX package compiles the
Lab conversion into its first map and contracts `500 * (fx - fy) - a_c`
into a fused multiply-add, so the first seed's own colour keeps a residue
of ~1e-13 and is picked once more. The port follows that arithmetic
(`models/kmeans.py::SeedLab`, `_first_map_compiled`) where the reference
fuses it, and seeds on stored Lab where the reference does (its vmapped
frame executables, its sharded trainers).

Two reference calls: the 2x2 two-colour image (its palette at k=8 and its
first two maps) and a 48x32 image of six flat regions at k=16 under CIE94
(replace, dither, meld). The batched and sharded seeds are held to the
port's own `plusplus_init`, with no further reference call.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
import kmeans_tpu_torch as kt
from kmeans_tpu.models import kmeans as ref_km
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu_torch.models import kmeans as km
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.delta_e import metric_fns
from kmeans_tpu_torch.parallel import make_mesh
from kmeans_tpu_torch.parallel.distributed import seed_sharded

RED, BLUE = (200, 30, 40), (10, 120, 220)
SIX = ((200, 30, 40), (10, 120, 220), (250, 250, 250), (30, 30, 30), (90, 200, 60),
       (240, 200, 20))


def _two_colour() -> np.ndarray:
    img = np.full((2, 2, 4), 255, np.uint8)
    img[0, :, :3], img[1, :, :3] = RED, BLUE
    return img


def _six_regions(h=32, w=48) -> np.ndarray:
    img = np.full((h, w, 4), 255, np.uint8)
    for i, col in enumerate(SIX):
        r, c = divmod(i, 3)
        img[r * h // 2:(r + 1) * h // 2, c * w // 3:(c + 1) * w // 3, :3] = col
    return img


@partial(jax.jit, static_argnames=("k",))
def _ref_maps(px, first, k):
    """The reference's `plusplus_init` as `_train_jit` compiles it (the Lab
    conversion in the same executable, the picks in a loop), keeping the
    map after each pick."""
    work = ref_lab(px[..., :3].reshape(-1, 3))
    _, dist_sq = ref_km.metric_fns("cie94")
    dmap = dist_sq(work, work[first][None, :])
    maps = jnp.zeros((k, work.shape[0]), jnp.float32).at[0].set(dmap)

    def body(j, carry):
        maps, dmap = carry
        dmap = jnp.minimum(dmap, dist_sq(work, work[jnp.argmax(dmap)][None, :]))
        return maps.at[j].set(dmap), dmap

    return jax.lax.fori_loop(1, k, body, (maps, dmap))[0]


def _port_maps(img: np.ndarray, first: int, k: int) -> np.ndarray:
    """The same maps from the port's seeding pieces."""
    seed = km.seed_lab(torch.from_numpy(img[..., :3].reshape(-1, 3)))
    n = seed.lab.shape[0]
    _, dist_sq = metric_fns("cie94")
    rows = torch.index_select(seed.lab, 0, torch.tensor([first]).expand(n))
    maps = [km._first_map(seed.lab, rows, "cie94", seed)]
    for _ in range(1, k):
        idx = torch.argmax(maps[-1]).reshape(1)
        maps.append(torch.minimum(maps[-1], dist_sq(
            seed.lab, torch.index_select(seed.lab, 0, idx.expand(n)))))
    return torch.stack(maps).numpy()


def test_two_colour_first_maps_are_the_references_bit_for_bit():
    """After the first pick the reference's map holds 2.6999521e-13 at the
    first seed's own colour, where a map of stored Lab holds 0; after the
    second pick it still does, and every other entry is 0. The port's maps
    have the same bits."""
    img = _two_colour()
    first = km.reference_seed_index(2, 2)
    want = np.asarray(_ref_maps(jnp.asarray(img), first, 3))
    got = _port_maps(img, first, 3)
    assert want[0, 2] > 0 and want[1, 2] > 0 and want[2].max() == 0
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_two_colour_palette_is_the_references():
    """palette(8) of the 2x2 image: 6 rows of red and 2 of blue in both
    packages (the port gave 7 and 1 before the repair)."""
    img = _two_colour()
    want = kmeans_tpu.ImageProcessor().palette(8, kmeans_tpu.Image((2, 2), img))
    got = kt.ImageProcessor(device="cpu").palette(8, img)
    np.testing.assert_array_equal(got, want)
    rows = [tuple(int(v) for v in r[:3]) for r in got]
    assert (rows.count(RED), rows.count(BLUE)) == (6, 2)


@pytest.fixture(scope="module")
def six_regions():
    img = _six_regions()
    ref = kmeans_tpu.ImageProcessor()
    port = kt.ImageProcessor(device="cpu")
    return img, ref, port


@pytest.mark.parametrize("mode", ["REPLACE", "DITHER", "MELD"])
def test_six_regions_reduce_is_the_references(six_regions, mode):
    """reduce(16) of six flat regions, CIE94: 0 pixels apart in every mode
    (meld differed on whole regions: two equal palette rows blend to NaN,
    written black)."""
    img, ref, port = six_regions
    want = ref.reduce(16, kmeans_tpu.Image((48, 32), img), kmeans_tpu.Algorithm.KMEANS,
                      getattr(kmeans_tpu.ReduceMode, mode)).pixels
    got = port.reduce(16, img, kt.Algorithm.KMEANS, getattr(kt.ReduceMode, mode)).pixels
    assert int((got != want).any(-1).sum()) == 0


@pytest.mark.parametrize("metric", ["cie94", "cie2000"])
def test_batched_and_sharded_seeds_follow_their_sites(metric):
    """No reference call. `plusplus_init_batched` with a `SeedLab` seeds each
    member as `plusplus_init` does alone (the reference's `reduce_batch`
    executable fuses the shared image's Lab into its first map), and
    `seed_sharded` on 1 and 2 CPU shards as `plusplus_init` on stored Lab
    (the reference converts apart from its sharded seeding, so it keeps no
    residue there). Under CIEDE2000 the maps take the pick's row laid out
    as the pixels: a pixel's distance to its own colour is 0 on the CPU."""
    img = _six_regions()
    rgb = torch.from_numpy(img[..., :3].reshape(-1, 3))
    lab, seed = srgb8_to_lab(rgb), km.seed_lab(rgb)
    first = km.reference_seed_index(48, 32)
    solo = [km.plusplus_init(lab, 16, first, ka, metric, seed=seed) for ka in (16, 9)]
    both = km.plusplus_init_batched(lab.expand(2, -1, 3), 16, [first] * 2, [16, 9], metric,
                                    seed=km.SeedLab(*(t.expand(2, *t.shape) for t in seed)))
    torch.testing.assert_close(both, torch.stack(solo), rtol=0, atol=0)
    # The residue's pick: the first seed's colour comes back once the six
    # are in (CIE94), then pixel 0 at every remaining tie.
    plain = km.plusplus_init(lab, 16, first, metric=metric)
    assert not torch.equal(plain, solo[0]) or metric == "cie2000"
    _, dist_sq = metric_fns(metric)
    assert float(dist_sq(lab, lab[:1].expand_as(lab).contiguous()).min()) == 0.0
    for shards in (1, 2):
        got = seed_sharded(make_mesh(["cpu"] * shards), lab, None, 16, first, metric=metric)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
