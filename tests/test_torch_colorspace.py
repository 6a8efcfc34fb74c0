"""PyTorch port vs the JAX package: colour conversions and CIE94.

The same inputs, made with numpy, go through `kmeans_tpu` (JAX on the CPU)
and `kmeans_tpu_torch` (plain PyTorch on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import colorspace as ref_cs
from kmeans_tpu.ops import delta_e as ref_de
from kmeans_tpu.ops.kernels import gamma_lut_values
from kmeans_tpu_torch.ops import colorspace as cs
from kmeans_tpu_torch.ops import delta_e as de
from kmeans_tpu_torch.ops.gamma_lut import gamma_lut, gamma_lut_np

torch.set_num_threads(2)


def test_gamma_lut_is_bit_equal_to_reference():
    want = np.asarray(gamma_lut_values(), np.float32).reshape(-1)
    assert np.array_equal(gamma_lut_np().view(np.uint32), want.view(np.uint32))
    got = gamma_lut("cpu")
    assert got.dtype == torch.float32 and got.shape == (256,)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", ["RGB_TO_XYZ", "XYZ_TO_RGB", "WHITE_POINT"])
def test_constants_equal(name):
    assert getattr(cs, name) == getattr(ref_cs, name)


def test_srgb8_to_lab_on_a_strided_grid():
    """Every second code on each channel: 128^3 (about 2.1M) colours. The
    gamma step is bit-equal (carried table); the cube root is torch's pow,
    which differs from XLA's by an ulp on some inputs, hence atol."""
    g = np.arange(0, 256, 2, dtype=np.uint8)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    want = np.asarray(ref_cs.srgb8_to_lab(jnp.asarray(grid)))
    got = cs.srgb8_to_lab(torch.from_numpy(grid)).numpy()
    exact = int((got == want).all(-1).sum())
    print(f"srgb8_to_lab: {exact} of {len(grid)} colours bit-equal")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_lab_to_srgb8_equal():
    rng = np.random.default_rng(0)
    n = 100_000
    lab = np.stack(
        [rng.uniform(0, 100, n), rng.uniform(-128, 128, n), rng.uniform(-128, 128, n)],
        -1,
    ).astype(np.float32)
    want = np.asarray(ref_cs.lab_to_srgb8(jnp.asarray(lab)))
    got = cs.lab_to_srgb8(torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(got, want)


def test_srgb8_to_lab_np_equal():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (5000, 3), dtype=np.uint8)
    np.testing.assert_array_equal(cs.srgb8_to_lab_np(rgb), ref_cs.srgb8_to_lab_np(rgb))


@pytest.mark.parametrize("name", ["srgb_to_linear", "linear_to_srgb", "srgb_to_lab"])
def test_float_conversions_match_reference(name):
    """The float public functions (`kmeans_tpu.ops.__all__`) on seeded
    values: [0, 1] colours, and for `linear_to_srgb` also the small
    negatives the XYZ->RGB matrix gives out-of-gamut Lab. torch's float32
    `pow` may differ from XLA's by an ulp, hence the tolerance."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (20_000, 3)).astype(np.float32)
    if name == "linear_to_srgb":
        x[:100] -= 1.01
    want = np.asarray(getattr(ref_cs, name)(jnp.asarray(x)))
    got = getattr(cs, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if name == "srgb_to_lab":  # the bar of test_srgb8_to_lab_on_a_strided_grid
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cie94_golden():
    """d(lab(255, 0, 0), lab(255, 128, 0)) == 19.094658 within the 0.01 of
    the reference's own golden test (tests/test_delta_e.py), and equal to
    the JAX package's value within float32 rounding."""
    rgb = np.array([[255, 0, 0], [255, 128, 0]], dtype=np.uint8)
    lab = cs.srgb8_to_lab(torch.from_numpy(rgb))
    got = float(de.distance_cie94(lab[0], lab[1]))
    ref = ref_cs.srgb8_to_lab(jnp.asarray(rgb))
    want = float(ref_de.distance_cie94(ref[0], ref[1]))
    assert abs(got - 19.094658) < 0.01
    assert abs(got - want) <= 1e-6 * want


def test_cie94_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(50, 30, size=(4096, 3)).astype(np.float32)
    y = rng.normal(50, 30, size=(4096, 3)).astype(np.float32)
    for ours, theirs in (
        (de.distance_cie94, ref_de.distance_cie94),
        (de.distance_cie94_sq, ref_de.distance_cie94_sq),
    ):
        got = ours(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(theirs(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_metric_fns():
    assert de.metric_fns("cie94") == (de.distance_cie94, de.distance_cie94_sq)
    assert de.metric_fns("cie2000") == (de.distance_cie2000, de.distance_cie2000_sq)
    with pytest.raises(ValueError):
        de.metric_fns("cie76")
