"""The assign pass: the port's plain twin vs the JAX package's Pallas kernel.

`assign_packed_reference` (plain PyTorch) must write the words that
`kmeans_tpu.ops.kernels.fused_assign_packed(..., interpret=True)` writes,
pad bits included. Any index that differs is counted; at most 1e-4 of
the pixels may differ, and each must be a near-tie under the reference's
own distances (|d1 - d2| <= 1e-4 * d1): the port's cube root is torch's
`pow`, which can differ from XLA's by an ulp. The CUDA kernel is held to
the twin in tests/test_torch_cuda.py, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops import kernels as ref_k
from kmeans_tpu.ops.colorspace import srgb8_to_lab as ref_lab
from kmeans_tpu.ops.delta_e import distance_cie94_sq as ref_d2
from kmeans_tpu.ops.quantize import BAYER_4X4
from kmeans_tpu.ops.quantize import dither_threshold as ref_threshold
from kmeans_tpu_torch.interop import centroids_from_reference
from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.quantize import assign_index
from kmeans_tpu_torch.utils.packing import pack_bits, unpack_tile_words

torch.set_num_threads(2)


def _case(h, w, k, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pal = np.array(ref_lab(jnp.asarray(rng.integers(0, 256, (k, 3), dtype=np.uint8))))
    return rgb, pal


def _reference_lab(rgb, thr, mode, row_offset, n_pad):
    """The reference kernel's per-pixel Lab, pad pixels and dither
    adjustment included, for judging flips."""
    h, w = rgb.shape[:2]
    flat = np.zeros((n_pad, 3), np.uint8)
    flat[: h * w] = rgb.reshape(-1, 3)
    lab = np.asarray(ref_lab(jnp.asarray(flat)))
    if mode == "dither":
        p = np.arange(n_pad)
        m = np.asarray(BAYER_4X4, np.float32) / np.float32(16.0) - np.float32(0.5)
        adj = np.float32(thr) * m[(p // w + row_offset) % 4, p % w % 4]
        lab = lab + adj[:, None]
    return lab


def _assert_words_match(rgb, pal, mode, k_active=None, row_offset=0):
    h, w = rgb.shape[:2]
    k = pal.shape[0]
    rgba = np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
    thr = float(ref_threshold(jnp.asarray(pal), k_active)) if mode == "dither" else 0.0
    want = np.asarray(
        ref_k.fused_assign_packed(
            jnp.asarray(rgba), jnp.asarray(pal), thr, k_active=k_active, mode=mode,
            row_offset=row_offset, interpret=True,
        )
    )
    got = kernels.assign_packed_reference(
        torch.from_numpy(rgb), centroids_from_reference(pal), thr, k_active, mode,
        row_offset,
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    bits, rows = pack_bits(k), kernels.quant_tile_rows(k)
    n_pad = want.size * (32 // bits)
    gi = unpack_tile_words(got, 1, n_pad, bits, rows).reshape(-1)
    wi = unpack_tile_words(want, 1, n_pad, bits, rows).reshape(-1)
    flips = np.flatnonzero(gi != wi)
    print(f"{h}x{w} k={k} {mode}: {len(flips)} flipped of {n_pad} indices")
    assert len(flips) <= int(1e-4 * h * w), flips
    if len(flips):
        lab = _reference_lab(rgb, thr, mode, row_offset, n_pad)[flips]
        d1 = np.asarray(ref_d2(jnp.asarray(lab), jnp.asarray(pal[wi[flips]])))
        d2 = np.asarray(ref_d2(jnp.asarray(lab), jnp.asarray(pal[gi[flips]])))
        assert (np.abs(d1 - d2) <= 1e-4 * d1).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["replace", "dither"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 17, 200, 257])
def test_twin_matches_pallas_kernel(k, mode):
    rgb, pal = _case(61, 97, k, seed=k)
    _assert_words_match(rgb, pal, mode)


@pytest.mark.parametrize("mode", ["replace", "dither"])
@pytest.mark.parametrize("shape,k", [((257, 129), 4), ((257, 129), 17), ((8, 8), 8)])
def test_twin_matches_pallas_kernel_ragged(shape, k, mode):
    rgb, pal = _case(*shape, k, seed=100 + k)
    _assert_words_match(rgb, pal, mode)


@pytest.mark.parametrize("k,k_active,mode", [(16, 11, "dither"), (40, 23, "replace")])
def test_twin_matches_pallas_kernel_k_active(k, k_active, mode):
    rgb, pal = _case(61, 97, k, seed=200 + k)
    _assert_words_match(rgb, pal, mode, k_active=k_active)


def test_twin_matches_pallas_kernel_row_offset():
    rgb, pal = _case(61, 97, 8, seed=300)
    _assert_words_match(rgb, pal, "dither", row_offset=3)


@pytest.mark.parametrize("k", [3, 16, 40, 300])
def test_words_unpack_to_plain_indices(k):
    """The packed layout inverts (utils/packing.py) to the plain argmin of
    ops/quantize.py, for each bit width."""
    rgb, pal = _case(45, 71, k, seed=400 + k)
    cents = centroids_from_reference(pal)
    words = kernels.assign_packed_reference(torch.from_numpy(rgb), cents, 0.0).numpy()
    got = unpack_tile_words(words, 45, 71, pack_bits(k), kernels.quant_tile_rows(k))
    want = assign_index(srgb8_to_lab(torch.from_numpy(rgb)), cents).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_cpu_call_does_not_count_a_launch():
    rgb, pal = _case(16, 16, 4, seed=5)
    kernels.LAUNCHES_BY_MODE.clear()
    kernels.assign_packed(torch.from_numpy(rgb), centroids_from_reference(pal), 0.0)
    assert kernels.launches("assign_packed") == 0


def test_wrapper_rejects_what_it_does_not_take():
    rgb, pal = _case(8, 8, 4, seed=6)
    t_rgb, cents = torch.from_numpy(rgb), centroids_from_reference(pal)
    with pytest.raises(ValueError, match="meld_packed"):
        kernels.assign_packed(t_rgb, cents, 0.0, mode="meld")
    with pytest.raises(ValueError, match="quantize_rgba serves any k"):
        kernels.assign_packed(t_rgb, torch.zeros((1025, 3)), 0.0)
    with pytest.raises(ValueError):
        kernels.assign_packed(t_rgb.float(), cents, 0.0)
    with pytest.raises(ValueError):
        kernels.assign_packed(t_rgb, cents, 0.0, k_active=5)


def _fake_nvcc(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_compiles_once_per_source_hash(tmp_path, monkeypatch):
    """`ops/_build.py` runs nvcc from CUDA_HOME (one compile for each
    source, then one link), writes the library under its hashed name, and
    does not rebuild an unchanged tree."""
    from kmeans_tpu_torch.ops import _build

    log = tmp_path / "calls"
    # The fake compiler records each call and creates the file after -o.
    home = _fake_nvcc(
        tmp_path,
        f'echo x >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n',
    )
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build()
    second = _build.build()
    assert first == second == _build.library_path(str(home / "bin" / "nvcc"))
    assert first.is_file() and first.parent == tmp_path / "build"
    assert log.read_text().count("x") == len(_build._sources()) + 1
    assert list((tmp_path / "build").iterdir()) == [first]


def test_header_edit_changes_the_library_hash(tmp_path, monkeypatch):
    """The library's name hashes the headers (`csrc/*.cuh`) too, which are
    not compiled on their own: an edited header builds a new library."""
    import shutil

    from kmeans_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.suffix for p in _build._sources()] == [".cu"] * len(_build._sources())
    before = _build.library_path("nvcc")
    header = csrc / "delta_e.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.library_path("nvcc") != before


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    from kmeans_tpu_torch.ops import _build

    home = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []
