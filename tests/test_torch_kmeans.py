"""PyTorch port vs the JAX package: seeding and Lloyd training.

Both sides get the same Lab training pixels (the reference's conversion
of a seeded synthetic image, as numpy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.models import kmeans as ref_km
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu_torch.interop import centroids_from_reference
from kmeans_tpu_torch.models import kmeans as km

torch.set_num_threads(2)


def _training_lab(h=144, w=256, seed=0):
    """Gradient-plus-noise pixels (the benchmark's synthetic recipe) as
    `[h * w, 3]` Lab float32."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    rgb = np.clip(rgb + rng.integers(-8, 9, rgb.shape), 0, 255).astype(np.uint8)
    return np.array(ref_lab(jnp.asarray(rgb.reshape(-1, 3))))


def test_reference_seed_index_equal():
    for w in (1, 2, 7, 97, 182, 256, 420):
        for h in (1, 3, 61, 144, 256):
            assert km.reference_seed_index(w, h) == ref_km.reference_seed_index(w, h)


@pytest.mark.parametrize("k", [1, 2, 8, 17])
def test_plusplus_init_identical(k):
    lab = _training_lab()
    first = ref_km.reference_seed_index(256, 144)
    want = np.asarray(ref_km.plusplus_init(jnp.asarray(lab), k, first))
    got = km.plusplus_init(torch.from_numpy(lab), k, first).numpy()
    np.testing.assert_array_equal(got, want)


def test_plusplus_init_k_active_leaves_zero_rows():
    lab = _training_lab(seed=1)
    got = km.plusplus_init(torch.from_numpy(lab), 8, 5, k_active=3).numpy()
    want = np.asarray(ref_km.plusplus_init(jnp.asarray(lab), 8, 5, k_active=3))
    np.testing.assert_array_equal(got, want)
    assert not got[3:].any()


def test_assign_clusters_matches():
    lab = _training_lab(seed=2)
    cents = lab[:: len(lab) // 9][:9]
    want = np.asarray(ref_km.assign_clusters(jnp.asarray(lab), jnp.asarray(cents)))
    got = km.assign_clusters(torch.from_numpy(lab), centroids_from_reference(cents)).numpy()
    flips = int((got != want).sum())
    assert flips <= len(lab) // 10000, flips


@pytest.mark.parametrize("k", [1, 2, 8, 17])
def test_fit_matches_reference(k):
    """Equal iteration counts (the 128/8 stop rule) and centroids within
    1e-3: the one-hot sums reduce in another order than XLA's."""
    lab = _training_lab()
    first = ref_km.reference_seed_index(256, 144)
    want_c, want_i = ref_km.fit(jnp.asarray(lab), k, first)
    got_c, got_i = km.fit(torch.from_numpy(lab), k, first)
    assert got_i == int(want_i)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-3)


def test_lloyd_stop_rule():
    """The loop only stops after iterations 8, 16, ...: with a convergence
    threshold every vote passes, it runs exactly 9; with none, all 128;
    with max_iterations=5 it stops at 5 without a check."""
    lab = torch.from_numpy(_training_lab(seed=3))
    cents = km.plusplus_init(lab, 4, 0)
    assert km.lloyd(lab, cents, convergence=1e9)[1] == 9
    assert km.lloyd(lab, cents, convergence=-1.0)[1] == 128
    assert km.lloyd(lab, cents, convergence=1e9, max_iterations=5)[1] == 5
    _, want = ref_km.lloyd(jnp.asarray(lab.numpy()), jnp.asarray(cents.numpy()), 1e9)
    assert int(want) == 9


def test_fit_restarts():
    lab = torch.from_numpy(_training_lab(seed=4))
    c1, i1 = km.fit_restarts(lab, 4, 7)
    c2, i2 = km.fit(lab, 4, 7)
    assert i1 == i2 and torch.equal(c1, c2)
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        km.fit_restarts(lab, 4, 7, restarts=2)
