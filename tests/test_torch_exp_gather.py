"""The port of `tools/exp_gather.py` against the reference on the CPU.

The reference defines its kernels inside `main()` (`try_form:48`,
`lut_kernel:152`, `pow_kernel:160`), so these tests recompute their bodies
with `jax.numpy` on the CPU from the same formulas and hold the port's
twins to them: the gather and the lut sum bit for bit, the pow sum within
8 ulps (torch's and XLA-CPU's `pow` differ by an ulp on a few inputs),
with the flips counted. The kernels themselves run only on a card:
`tests/test_torch_cuda.py`.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu_torch.tools import exp_gather

REPEAT = 8


def _ref_table():
    # tools/exp_gather.py:47
    return (np.arange(256, dtype=np.float32) / 255.0) ** 2.4


def _ref_lut(idx):
    tbl = jnp.asarray(_ref_table())
    acc = jnp.zeros(idx.shape, jnp.float32)
    for j in range(REPEAT):
        acc = acc + tbl[(jnp.asarray(idx) + j) & 255]
    return np.array(acc)


def _ref_pow(idx):
    acc = jnp.zeros(idx.shape, jnp.float32)
    for j in range(REPEAT):
        c = ((jnp.asarray(idx) + j) & 255).astype(jnp.float32) / 255.0
        acc = acc + jnp.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
    return np.array(acc)


def _grid(rows, seed):
    return exp_gather.grid_indices(np.random.default_rng(seed), rows)


def test_table_is_the_references():
    np.testing.assert_array_equal(exp_gather.gamma_table_np().view(np.uint32),
                                  _ref_table().view(np.uint32))
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(exp_gather.gather_indices(),
                                  rng.integers(0, 256, (128, 128)).astype(np.int32))


def test_grid_is_the_references_4k_grid():
    n = 3840 * 2160
    m = (n + 128 - 1) // 128
    assert exp_gather.GRID_ROWS == (m + 128 - 1) // 128 * 128 == 64_896


@pytest.mark.parametrize("placement", exp_gather.PLACEMENTS)
def test_gather_twin_returns_the_table_bits(placement):
    idx = exp_gather.gather_indices()
    want = np.asarray(jnp.asarray(_ref_table())[jnp.asarray(idx)])
    got = exp_gather.gather(exp_gather.gamma_table("cpu"), torch.from_numpy(idx), placement)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("rows,seed", [(128, 3), (256, 11)])
def test_lut_twin_matches_reference_bits(rows, seed):
    idx = _grid(rows, seed)
    got = exp_gather.lut_sum(exp_gather.gamma_table("cpu"), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _ref_lut(idx).view(np.uint32))


@pytest.mark.parametrize("rows,seed", [(128, 3), (256, 11)])
def test_pow_twin_matches_reference_within_8_ulps(rows, seed):
    idx = _grid(rows, seed)
    got = exp_gather.pow_sum(torch.from_numpy(idx))
    ulps = exp_gather.ulps(got, torch.from_numpy(_ref_pow(idx)))
    assert int(ulps.max()) <= 8, f"{int((ulps > 0).sum())} sums differ, max {int(ulps.max())}"


def test_pow_table_twin_within_an_ulp_of_numpy():
    u = exp_gather.ulps(exp_gather.pow_table("cpu"), exp_gather.gamma_table("cpu"))
    assert int(u.max()) <= 1


def test_ulps_counts_units_in_the_last_place():
    a = torch.tensor([1.0, 2.0, 0.0])
    b = torch.nextafter(a, torch.full_like(a, 10.0))
    assert exp_gather.ulps(a, b).tolist() == [1, 1, 1]


def test_wrappers_reject_what_the_kernels_do_not_take():
    idx = torch.zeros((4, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        exp_gather.pow_sum(idx)
    with pytest.raises(ValueError, match="256"):
        exp_gather.gather(torch.zeros(128), idx.to(torch.int32))


def test_tool_on_cpu(capsys):
    assert exp_gather.main(["--cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["form"] for line in lines[:3]] == list(exp_gather.PLACEMENTS)
    assert all(line["correct"] for line in lines[:3])
    assert lines[3] == {"working_forms": list(exp_gather.PLACEMENTS)}
    assert lines[-1]["elements"] == exp_gather.GRID_ROWS * 128
    assert lines[-1]["pow_ms"] == "not measured"
