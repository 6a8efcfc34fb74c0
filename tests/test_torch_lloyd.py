"""PyTorch port vs the JAX package: the Lloyd tile accumulator.

The port's plain twin `lloyd_accumulate_reference` (the spec of the CUDA
kernel `csrc/lloyd_accumulate.cu`) is held against the Pallas kernel
`kmeans_tpu.ops.kernels.lloyd_accumulate` run in interpret mode, on the
same planes made from numpy seeds.

Tolerance: counts are equal exactly (sums of 1.0, or of small integer
weights); the other columns are float32 sums taken in another order, so
each must lie within `1e-5 * (|want| + 128 * count)` of the reference:
relative 1e-5, plus the same bound on the sum of magnitudes (|L|, |a|,
|b| <= 128), which covers a and b sums that cancel towards 0.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import kernels as ref_kernels
from kmeans_tpu_torch.ops import kernels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _lab(n, seed):
    """`[n, 3]` float32 Lab spread over the gamut, with a cluster of
    duplicates so that exact ties occur."""
    rng = np.random.default_rng(seed)
    lab = rng.uniform([0, -80, -80], [100, 80, 80], (n, 3)).astype(np.float32)
    lab[: n // 10] = lab[0]
    return lab


def _pair(lab, dtype=None):
    """The same planes for both packages: `(ref planes, port planes, n)`."""
    ref_planes, n = ref_kernels.pack_lab_planes(
        jnp.asarray(lab), dtype=None if dtype is None else jnp.bfloat16
    )
    planes, n_port = kernels.pack_lab_planes(
        torch.from_numpy(lab), None if dtype is None else torch.bfloat16
    )
    assert n == n_port
    return ref_planes, planes, n


def _assert_totals(got, want):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    bound = 1e-5 * (np.abs(want) + 128.0 * want[:, 3:4])
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), np.max(excess)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_pack_lab_planes_bit_equal(dtype):
    lab = _lab(20000, 1)
    ref_planes, planes, n = _pair(lab, dtype)
    assert n == 20000 and tuple(planes.shape) == (3, 256, 128)
    if dtype is None:
        np.testing.assert_array_equal(planes.numpy(), np.asarray(ref_planes))
    else:
        want = np.asarray(ref_planes).view(np.uint16)
        np.testing.assert_array_equal(planes.view(torch.int16).numpy().view(np.uint16), want)
    weights = np.random.default_rng(2).uniform(0, 2, 20000).astype(np.float32)
    np.testing.assert_array_equal(
        kernels.pack_plane(torch.from_numpy(weights)).numpy(),
        np.asarray(ref_kernels.pack_plane(jnp.asarray(weights))),
    )


CASES = {
    # name: (n, kp, k_active, weighted, emit_inertia, dtype)
    "k1": (3000, 1, None, False, True, None),
    "ragged_k_active": (16385, 8, 5, False, False, None),
    "weighted_inertia": (12345, 6, None, True, True, None),
    "bf16_inertia": (17000, 7, 4, False, True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_pallas_interpret(case):
    n, kp, k_active, weighted, inertia, dtype = CASES[case]
    lab = _lab(n, 10 + kp)
    ref_planes, planes, n_valid = _pair(lab, dtype)
    rng = np.random.default_rng(20 + kp)
    cents = lab[rng.choice(n, kp, replace=False)] + rng.normal(0, 2, (kp, 3)).astype(np.float32)
    cents[-1] = cents[0]  # a duplicate centroid: the first must win the tie
    # Integer weights (0 drops a pixel, as bucketing's pads): their sums,
    # the counts, stay exact in any order.
    w = rng.integers(0, 4, n).astype(np.float32) if weighted else None
    want = ref_kernels.lloyd_accumulate(
        ref_planes, jnp.asarray(cents), n_valid, k_active=k_active,
        weight_planes=None if w is None else ref_kernels.pack_plane(jnp.asarray(w)),
        interpret=True, emit_inertia=inertia,
    )
    got = kernels.lloyd_accumulate_reference(
        planes, torch.from_numpy(cents), n_valid, k_active=k_active,
        weight_planes=None if w is None else kernels.pack_plane(torch.from_numpy(w)),
        emit_inertia=inertia,
    )
    assert got.dtype == torch.float32
    _assert_totals(got, want)
    if k_active is not None:
        assert not got[k_active:].any()


def test_cpu_wrapper_runs_the_twin_and_launches_nothing():
    kernels.LAUNCHES_BY_MODE.clear()
    lab = _lab(5000, 3)
    planes, n = kernels.pack_lab_planes(torch.from_numpy(lab))
    cents = torch.from_numpy(lab[:4].copy())
    got = kernels.lloyd_accumulate(planes, cents, n, emit_inertia=True)
    want = kernels.lloyd_accumulate_reference(planes, cents, n, emit_inertia=True)
    assert torch.equal(got, want) and float(got[:, 3].sum()) == n
    assert kernels.launches("lloyd_accumulate") == 0


@pytest.mark.parametrize(
    "kwargs,error,match",
    [({"metric": "cie76"}, ValueError, "unknown metric"),
     ({"metric": "cie76", "fast": True}, ValueError, "unknown metric"),
     ({"k_active": 0}, ValueError, "k_active"),
     ({"k_active": 5, "fast": True}, ValueError, "k_active")],
)
def test_accumulator_argument_rules(kwargs, error, match):
    planes, n = kernels.pack_lab_planes(torch.zeros((10, 3)))
    with pytest.raises(error, match=match):
        kernels.lloyd_accumulate(planes, torch.zeros((4, 3)), n, **kwargs)


def test_accumulator_shape_rules():
    planes, n = kernels.pack_lab_planes(torch.zeros((10, 3)))
    with pytest.raises(ValueError, match="k <= 512"):
        kernels.lloyd_accumulate(planes, torch.zeros((513, 3)), n)
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.lloyd_accumulate(planes[:, :64], torch.zeros((4, 3)), n)
    with pytest.raises(ValueError, match="weight_planes"):
        kernels.lloyd_accumulate(planes, torch.zeros((4, 3)), n,
                                 weight_planes=torch.ones(64, 128))


def test_api_has_no_train_route_refusal():
    """Static check: every training the reference routes past its size
    gates now runs, so the refusal helper is gone from the API."""
    tree = ast.parse((ROOT / "kmeans_tpu_torch" / "api.py").read_text())
    names = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert "_check_train_route" not in names and "_fit_auto" in names
