"""Hardware experiment: the factorized CIE94 argmin on CUDA cores against
tensor cores.

Port of `tools/exp_mxu.py`. CIE94's squared distance splits into a term of
the pixel alone plus `F(p) . G(c)`, with six pixel factors (`screen_factors`
in `ops/kernels.py`, the reference's `_pixel_features:73`) and seven
per-centroid features (`factor_g_table`, the reference's `_g_table:143`).
The argmin of `F . G` is the fast tier's nearest centroid; the score is
`f0 g0 + g1 + f2 g2 + q g3 + f4 g4 + f5 g5 + rsh2 g6`, argmin with strict
`<` (the first index on ties), over every centroid (no k <= 16 gate, no
`k_active`, no dither). Two kernels (`tools/csrc/exp_mxu.cu`):

- `factor_vpu` (the reference's `_factor_vpu_kernel:94`): a register
  tile of pixels a thread on CUDA cores, the G-table in shared memory
  (padded to 8 columns), the centroid loop outermost. Its twin
  `factor_vpu_reference` is the port's factorized argmin; the two are
  equal bit for bit, and equal `assign_u8(fast=True)` at 16 < k <= 256.
- `factor_mxu` (the reference's `_factor_mxu_kernel:118`): each pixel's
  eight features `[f0, 1, f2, q, f4, f5, rsh2, 0]` times the `[8, kp]`
  padded, transposed G as TF32 `wgmma` products on tensor cores, in
  chunks of KC = 64 centroids: the first minimum inside a chunk, merged
  across chunks with strict `<`. G goes to the kernel in `wgmma`'s
  shared-memory layout (`mxu_b_operand`), its columns padded to whole
  chunks with columns that score +inf. Its twin
  `factor_mxu_reference(tf32=...)`
  sums the eight products left to right in float32; with `tf32=True` it
  first rounds both operands to TF32 (`tf32_round`: to nearest, ties away,
  as `cvt.rna.tf32.f32`), whose products are exact in float32, so only
  the tensor core's accumulation order separates the kernel from it.
  Single-pass TF32 keeps 11 significant bits of terms that reach 10^4, so
  it moves scores by units: expect more pixels to move against the exact
  kernel than the reference's 1e-3 bar between its own tiers.

On a CPU tensor each wrapper runs its twin (`factor_mxu` with
`tf32=True`, what the card computes); on a CUDA tensor it launches its
kernel or raises.

    python -m kmeans_tpu_torch.tools.exp_mxu [--smoke] [--cpu]

prints one JSON line per measurement, as the reference does: the variants
`rolled-fast` (the port's `assign_u8(fast=True)`), `factor-vpu` and
`factor-mxu` on a seeded uniform 3840x2160 RGBA image at k = 64 and 256
(`--smoke`: 40x100 at k = 64), Lab-ish random centroids (L in [0, 100], a
and b in [-60, 60]), each with `ms` (median of CUDA-event timings, cold
L2), `gpix_s` and `mismatch_frac_vs_exact` against the port's
`assign_u8(fast=False)`; then `{"all": [...]}`. It needs a card; `--cpu`
runs the twins on the CPU instead (use it with `--smoke`), where no device
time exists and `ms` reads "not measured".
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.ops.colorspace import srgb8_to_lab
from kmeans_tpu_torch.ops.gamma_lut import gamma_lut
from kmeans_tpu_torch.ops.kernels import factor_g_table, screen_factors, screen_score
from kmeans_tpu_torch.tools import _exp

WIDTH, HEIGHT = 3840, 2160
KS = (64, 256)
SMOKE_H, SMOKE_W, SMOKE_K = 40, 100, 64
KC = 64  # centroids per chunk of the tensor-core form
MAX_K = 256  # the index is written as one byte
MISMATCH_BAR = 1e-3  # the reference's bar between its own tiers
# A flip is a near-tie when the twin's scores of the two picks are within
# NEAR_TIE * max(|best score|, 1) of each other.
NEAR_TIE = 2.0 ** -10
# Pixels per slice of the tensor-core twin: bounds its [rows, KC] temporaries.
_TWIN_ROWS = 1 << 20
_BIG = 3.4e38
# What `exp_factor_vpu` returns for RGBA words off a 16-byte boundary
# (cudaErrorMisalignedAddress): it never reads them.
CUDA_ERROR_MISALIGNED_ADDRESS = 716


def _check(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor) -> None:
    if rgba_u8.dtype != torch.uint8 or rgba_u8.dim() != 3 or rgba_u8.shape[-1] != 4:
        raise ValueError(f"expected [H, W, 4] uint8 RGBA, got {tuple(rgba_u8.shape)} "
                         f"{rgba_u8.dtype}")
    if centroids_lab.dim() != 2 or centroids_lab.shape[1] != 3:
        raise ValueError(f"expected [K, 3] centroids, got {tuple(centroids_lab.shape)}")
    if not 1 <= centroids_lab.shape[0] <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {centroids_lab.shape[0]}")


def _pixel_factors(rgba_u8: torch.Tensor):
    """`screen_factors` of every pixel, flattened: `(rsh2, q, f0, f2, f4,
    f5)`, each `[H * W]` float32."""
    lab = srgb8_to_lab(rgba_u8[..., :3].reshape(-1, 3))
    l, a, b = lab[:, 0], lab[:, 1], lab[:, 2]
    return screen_factors(l, a, b, torch.sqrt(a * a + b * b))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit significand bits),
    ties away from zero, as `cvt.rna.tf32.f32` rounds: add half of the
    dropped 13 bits to the magnitude, then clear them. Infinities and NaNs
    pass unchanged."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, rounded).view(torch.float32)


def factor_vpu_reference(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor) -> torch.Tensor:
    """Plain twin of `factor_vpu`: `[H, W]` uint8, the index of each
    pixel's least `screen_score` over all kp centroids, strict `<`."""
    _check(rgba_u8, centroids_lab)
    factors = _pixel_factors(rgba_u8)
    gtab = factor_g_table(centroids_lab.to(rgba_u8.device))
    best_d = torch.full_like(factors[0], _BIG)
    best_k = torch.zeros(best_d.shape, dtype=torch.int64, device=best_d.device)
    for k in range(gtab.shape[0]):
        s = screen_score(factors, gtab[k])
        take = s < best_d
        best_d = torch.where(take, s, best_d)
        best_k = torch.where(take, k, best_k)
    return best_k.to(torch.uint8).reshape(rgba_u8.shape[0], rgba_u8.shape[1])


def mxu_operands(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor, tf32: bool):
    """`(feats [N, 8], gmat [8, kp])` of the product form: each pixel's
    `[f0, 1, f2, q, f4, f5, rsh2, 0]` and the transposed G-table with a
    zero row, rounded to TF32 when `tf32`."""
    rsh2, q, f0, f2, f4, f5 = _pixel_factors(rgba_u8)
    one, zero = torch.ones_like(f0), torch.zeros_like(f0)
    feats = torch.stack([f0, one, f2, q, f4, f5, rsh2, zero], dim=1)
    gtab = factor_g_table(centroids_lab.to(rgba_u8.device))
    gmat = torch.cat([gtab, torch.zeros_like(gtab[:, :1])], dim=1).T.contiguous()
    if tf32:
        feats, gmat = tf32_round(feats), tf32_round(gmat)
    return feats, gmat


def mxu_width(kp: int) -> int:
    """The columns of `factor_mxu`'s product for kp centroids: kp rounded
    up to whole chunks of KC."""
    return -(-kp // KC) * KC


def mxu_b_operand(centroids_lab: torch.Tensor) -> torch.Tensor:
    """`factor_mxu`'s B operand: `[kp_pad * 8]` float32, kp_pad =
    `mxu_width(kp)`. Each centroid's row `[g0, ..., g6, 0]` of
    `mxu_operands`' G, rounded to TF32, and for the padded columns
    `[0, +inf, 0, ...]` (times the feature 1: a score of +inf, which
    strict `<` never takes). Laid out as `wgmma` reads a K-major operand
    without swizzle: per 8 centroids, their features 0-3 (an 8 x 16-byte
    core matrix), then their features 4-7."""
    gtab = factor_g_table(centroids_lab)
    kp = gtab.shape[0]
    kp_pad = mxu_width(kp)
    rows = torch.zeros((kp_pad, 8), dtype=torch.float32, device=gtab.device)
    rows[:kp, :7] = gtab
    rows[kp:, 1] = float("inf")
    rows = tf32_round(rows)
    return rows.reshape(kp_pad // 8, 8, 2, 4).permute(0, 2, 1, 3).contiguous().reshape(-1)


def _scores(feats: torch.Tensor, gmat: torch.Tensor) -> torch.Tensor:
    """`feats @ gmat` in float32 with each row's eight products summed left
    to right: a fixed order on every device, and no matmul-precision
    setting applies."""
    s = feats[:, 0:1] * gmat[0]
    for j in range(1, 8):
        s = s + feats[:, j:j + 1] * gmat[j]
    return s


def factor_scores(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor,
                  tf32: bool) -> torch.Tensor:
    """The twin's `[H * W, kp]` scores (keep the image small)."""
    _check(rgba_u8, centroids_lab)
    return _scores(*mxu_operands(rgba_u8, centroids_lab, tf32))


def factor_mxu_reference(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor,
                         tf32: bool = True, kc: int = KC) -> torch.Tensor:
    """Plain twin of `factor_mxu`: `[H, W]` uint8. Per chunk of `kc`
    centroids the first minimum of `_scores` (`argmin`), merged into the
    pixel's best with strict `<` (tools/exp_mxu.py:133-145). `tf32=False`
    keeps float32 operands (the reference's product on the CPU);
    `tf32=True` rounds them as the tensor cores take them."""
    _check(rgba_u8, centroids_lab)
    best = chunked_argmin(*mxu_operands(rgba_u8, centroids_lab, tf32), kc)
    return best.to(torch.uint8).reshape(rgba_u8.shape[0], rgba_u8.shape[1])


def chunked_argmin(feats: torch.Tensor, gmat: torch.Tensor, kc: int = KC) -> torch.Tensor:
    """`[N]` int64: per chunk of `kc` columns of `gmat` the first minimum
    of `_scores`, merged into each row's best with strict `<`."""
    out = []
    for rows in torch.split(feats, _TWIN_ROWS):
        best_d = torch.full((rows.shape[0],), _BIG, dtype=torch.float32, device=rows.device)
        best_k = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
        for c0 in range(0, gmat.shape[1], kc):
            s = _scores(rows, gmat[:, c0:c0 + kc])
            i = torch.argmin(s, dim=1)
            d = s.gather(1, i[:, None])[:, 0]
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_k = torch.where(take, i + c0, best_k)
        out.append(best_k)
    return torch.cat(out)


def near_ties(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor, got: torch.Tensor,
              want: torch.Tensor, tf32: bool) -> tuple[int, bool]:
    """`(flips, all near-ties)`: the pixels where the index `got` differs
    from the twin's `want` (both `[H, W]`), and whether at every one the
    twin's scores of the two picks are within `NEAR_TIE * max(|best|, 1)`.
    Scores only the flipped pixels."""
    flips = torch.nonzero((got != want).reshape(-1)).reshape(-1)
    if flips.numel() == 0:
        return 0, True
    pixels = rgba_u8.reshape(-1, 4)[flips].reshape(-1, 1, 4)
    scores = factor_scores(pixels, centroids_lab, tf32)
    rows = torch.arange(flips.numel(), device=scores.device)
    s_got = scores[rows, got.reshape(-1)[flips].long()]
    s_want = scores[rows, want.reshape(-1)[flips].long()]
    bar = NEAR_TIE * torch.clamp(s_want.abs(), min=1.0)
    return int(flips.numel()), bool(((s_got - s_want).abs() <= bar).all())


def _words(rgba_u8: torch.Tensor) -> torch.Tensor:
    if not rgba_u8.is_contiguous():
        raise ValueError("the kernels need a contiguous RGBA image")
    return rgba_u8.reshape(-1, 4).view(torch.int32)


def _launch_checks(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor, name: str) -> None:
    if rgba_u8.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {rgba_u8.device}")
    if centroids_lab.device != rgba_u8.device or centroids_lab.dtype != torch.float32:
        raise ValueError("centroids must be float32 on the image's device")


def factor_vpu(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor) -> torch.Tensor:
    """`[H, W]` uint8 nearest index by the factorized score on CUDA cores;
    see `factor_vpu_reference`. A CPU tensor runs the twin; a CUDA tensor
    launches `tools/csrc/exp_mxu.cu::factor_vpu_kernel` or raises."""
    _check(rgba_u8, centroids_lab)
    if rgba_u8.device.type == "cpu":
        return factor_vpu_reference(rgba_u8, centroids_lab)
    _launch_checks(rgba_u8, centroids_lab, "factor_vpu")
    lib = _exp.load_exp_library()
    words = _words(rgba_u8)
    if words.data_ptr() % 16:
        # The kernel reads runs of four words as one 16-byte load; a view
        # that starts elsewhere (a row slice of an odd-width image) goes
        # through an aligned copy.
        words = words.clone()
    n, kp = words.shape[0], centroids_lab.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=rgba_u8.device)
    with torch.cuda.device(rgba_u8.device):
        gtab = factor_g_table(centroids_lab)
        err = lib.exp_factor_vpu(words.data_ptr(), n, gtab.data_ptr(), kp,
                                 gamma_lut(rgba_u8.device).data_ptr(), out.data_ptr(),
                                 _exp.stream_of(out))
    _exp.check(lib, err, "factor_vpu")
    kernels.LAUNCHES_BY_MODE["exp_factor_vpu", "cie94", "factor"] += 1
    return out.reshape(rgba_u8.shape[0], rgba_u8.shape[1])


def factor_mxu(rgba_u8: torch.Tensor, centroids_lab: torch.Tensor) -> torch.Tensor:
    """`[H, W]` uint8 nearest index by the factorized score as TF32
    `wgmma` products in chunks of KC; see `factor_mxu_reference`. A CPU
    tensor runs the twin with `tf32=True`; a CUDA tensor launches
    `tools/csrc/exp_mxu.cu::factor_mxu_kernel` or raises."""
    _check(rgba_u8, centroids_lab)
    if rgba_u8.device.type == "cpu":
        return factor_mxu_reference(rgba_u8, centroids_lab, tf32=True)
    _launch_checks(rgba_u8, centroids_lab, "factor_mxu")
    lib = _exp.load_exp_library()
    words = _words(rgba_u8)
    n, kp = words.shape[0], centroids_lab.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=rgba_u8.device)
    with torch.cuda.device(rgba_u8.device):
        gb = mxu_b_operand(centroids_lab)
        err = lib.exp_factor_mxu(words.data_ptr(), n, gb.data_ptr(), kp, gb.numel() // 8,
                                 gamma_lut(rgba_u8.device).data_ptr(), out.data_ptr(),
                                 _exp.stream_of(out))
    _exp.check(lib, err, "factor_mxu")
    kernels.LAUNCHES_BY_MODE["exp_factor_mxu", "cie94", "tf32"] += 1
    return out.reshape(rgba_u8.shape[0], rgba_u8.shape[1])


def random_image(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform RGBA with alpha 255, drawn as the reference draws it."""
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    return rgba


def random_centroids(kp: int, rng: np.random.Generator) -> np.ndarray:
    """Lab-ish random centroids: L in [0, 100], a and b in [-60, 60]."""
    return np.stack([rng.uniform(0, 100, kp), rng.uniform(-60, 60, kp),
                     rng.uniform(-60, 60, kp)], axis=1).astype(np.float32)


def variants(img: torch.Tensor, cents: torch.Tensor) -> dict:
    """The measured variants, by the reference's names."""
    rgb = img[..., :3].contiguous()
    return {
        "rolled-fast": lambda: kernels.assign_u8(rgb, cents, 0.0, fast=True),
        "factor-vpu": lambda: factor_vpu(img, cents),
        "factor-mxu": lambda: factor_mxu(img, cents),
    }


def measure(device: torch.device, smoke: bool, reps: int = 10) -> list[dict]:
    """The tool's lines: every variant at every k, on `device`. Each
    variant runs once for its indices (one launch of its kernel on the
    card), then `reps` more times under CUDA events when `reps > 0` and
    there is a card."""
    if smoke:
        rng = np.random.default_rng(2)
        shape, ks = (SMOKE_H, SMOKE_W), (SMOKE_K,)
    else:
        rng = np.random.default_rng(0)
        shape, ks = (HEIGHT, WIDTH), KS
    img = torch.from_numpy(random_image(*shape, rng)).to(device)
    n = shape[0] * shape[1]
    timed = device.type == "cuda" and reps > 0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device) if timed else None
    lines = []
    for kp in ks:
        cents = torch.from_numpy(random_centroids(kp, rng)).to(device)
        exact = kernels.assign_u8(img[..., :3].contiguous(), cents, 0.0)
        for name, fn in variants(img, cents).items():
            mismatch = float((fn() != exact).double().mean())
            ms = _exp.median_ms(fn, reps, flush) if timed else "not measured"
            lines.append({
                "variant": name, "k": kp, "h": shape[0], "w": shape[1],
                "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "ms": ms, "gpix_s": n / ms / 1e6 if timed else "not measured",
                "mismatch_frac_vs_exact": mismatch,
                "within_bar": mismatch < MISMATCH_BAR,
            })
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--smoke", action="store_true", help="40x100 at k = 64")
    parser.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    args = parser.parse_args(argv)
    device = _exp.device_for(args.cpu, "exp_mxu")
    if device.type == "cuda":
        print(json.dumps({"card": _exp.card_line()}), flush=True)
    lines = measure(device, args.smoke)
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"all": lines}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
