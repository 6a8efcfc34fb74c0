"""Sharded output passes: an image's rows split over the mesh's pixel axis.

Port of `kmeans_tpu/parallel/sharded_ops.py`. The output pass is per
pixel, so no partial crosses between shards: the rows pad up to a
multiple of the shard count, shard s takes rows `[s * local_h, (s + 1) *
local_h)` on its device, and each shard launches the single-device
kernel on its block:

- replace and dither up to `INDEXED_MAX_K` colours: `assign_packed`
  (`csrc/quantize_assign.cu`), with `row_offset = s * local_h` so the
  Bayer phase is the whole image's on every shard; the dither threshold is
  computed once, on the whole palette (`csrc/dither_threshold.cu`);
- past it: the same kernel's colour-out mode, `quantize_rgba`, with the
  same `row_offset`;
- meld: `meld_packed` (`csrc/quantize_meld.cu`), which has no row phase.

On the CPU each wrapper runs its plain twin. The host inverts each shard's
words with the unpack of the kp-keyed `quant_tile_rows` at `local_h` rows
(the native runtime, `runtime.unpack_indices_gather` / `unpack_rgb24`),
writes them into its rows of one output and crops the padding. The words
go back as one array, shard blocks in order, as the reference's do; the
unpacks also take the list of shard blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from kmeans_tpu_torch.ops.kernels import (
    INDEXED_MAX_K,
    assign_packed,
    meld_packed,
    quant_tile_rows,
    quantize_rgba,
)
from kmeans_tpu_torch.ops.quantize import dither_threshold
from kmeans_tpu_torch.parallel.collectives import replicate, shard_rows, to_device
from kmeans_tpu_torch.utils.packing import (
    pack_bits,
    unpack_rgb24_tile_words,
    unpack_tile_words,
    unpack_tile_words_gather,
)


def _row_sharded(mesh, rgb_u8):
    """`(blocks, h, local_h)`: the `[H, W, 3|4]` uint8 image's RGB rows
    padded with zero rows to a multiple of the pixel-axis size and split,
    block s (`[local_h, W, 3]`, contiguous) on the s-th device of the
    mesh's first row (kmeans_tpu/parallel/sharded_ops.py:36). A host array
    pads on the host and each block uploads to its device; a tensor pads
    on its own device and each block moves to its shard's device."""
    devices = mesh.row(0)
    if not isinstance(rgb_u8, torch.Tensor):
        rgb_u8 = torch.from_numpy(np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8)))
    if rgb_u8.dtype != torch.uint8 or rgb_u8.dim() != 3 or rgb_u8.shape[-1] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {tuple(rgb_u8.shape)} {rgb_u8.dtype}")
    h = rgb_u8.shape[0]
    local_h = shard_rows(h, len(devices))
    rgb = rgb_u8[..., :3]
    if local_h * len(devices) != h:
        pad = torch.zeros((local_h * len(devices) - h,) + tuple(rgb.shape[1:]),
                          dtype=torch.uint8, device=rgb.device)
        rgb = torch.cat([rgb, pad])
    blocks = [to_device(rgb[s * local_h:(s + 1) * local_h].contiguous(), d)
              for s, d in enumerate(devices)]
    return blocks, h, local_h


def _palette(palette_lab, root) -> torch.Tensor:
    return torch.as_tensor(palette_lab, dtype=torch.float32).to(root).contiguous()


def _shard_palettes(blocks, palette_lab, mode, k_active, metric):
    """Per shard `(palette, threshold)` on its device: the palette copied,
    the dither threshold computed once on the first device (0.0 for
    replace) and copied."""
    devices = [b.device for b in blocks]
    pals = replicate(palette_lab, devices)
    if mode != "dither":
        return [(p, 0.0) for p in pals]
    thr = dither_threshold(palette_lab, k_active, metric)
    return list(zip(pals, replicate(thr, devices)))


def _assign_words(blocks, local_h, palette_lab, mode, k_active, metric, fast, colour_out=False):
    """One launch of the assign kernel a shard, `row_offset = s * local_h`:
    the shards' packed words (or, with `colour_out`, `[local_h, W, 4]`
    RGBA), on their devices, in shard order."""
    launch = quantize_rgba if colour_out else assign_packed
    return [launch(block, pal, thr, k_active, mode=mode, row_offset=s * local_h, metric=metric,
                   fast=fast)
            for s, (block, (pal, thr)) in enumerate(
                zip(blocks, _shard_palettes(blocks, palette_lab, mode, k_active, metric)))]


def _meld_words(blocks, palette_lab, k_active, metric, fast):
    """One launch of the meld kernel a shard: the shards' RGB24 words."""
    return [meld_packed(block, pal, k_active, metric=metric, fast=fast)
            for block, pal in zip(blocks, replicate(palette_lab, [b.device for b in blocks]))]


def _fetch(parts) -> list:
    """The shards' outputs on the host, in shard order."""
    return [p.cpu().numpy() for p in parts]


def _check_indexed(kp: int, mode: str, what: str) -> None:
    if kp > INDEXED_MAX_K:
        raise ValueError(f"packed indexed readback requires k <= {INDEXED_MAX_K}")
    if mode not in ("replace", "dither"):
        raise ValueError(f"{what} supports replace/dither only")


def assign_fused_sharded(mesh, rgb_u8, palette_lab, mode: str = "replace", k_active=None,
                         metric: str = "cie94", fast: bool = False):
    """Packed palette indices of the row-sharded image, one assign launch a
    shard (kmeans_tpu/parallel/sharded_ops.py:121): `(words, bits)`, the
    `[D * M, 128]` int32 host words (shard blocks in order) that
    `unpack_fused_sharded` inverts. Replace/dither, k <= `INDEXED_MAX_K`."""
    palette_lab = _palette(palette_lab, mesh.root)
    _check_indexed(palette_lab.shape[0], mode, "assign_fused_sharded")
    blocks, _, local_h = _row_sharded(mesh, rgb_u8)
    words = _fetch(_assign_words(blocks, local_h, palette_lab, mode, k_active, metric, fast))
    return np.concatenate(words), pack_bits(palette_lab.shape[0])


def assign_indexed_sharded(mesh, rgb_u8, palette_lab, mode: str = "replace", k_active=None,
                           metric: str = "cie94"):
    """The `[H, W]` index map of the row-sharded image and its bits a
    pixel (kmeans_tpu/parallel/sharded_ops.py:93): uint8, or uint16 past
    256 colours. The reference reads its map back width-packed from an XLA
    executable on CPU meshes; here every mesh runs the assign kernel (or
    its twin), whose tile words `unpack_fused_sharded` turns into the map."""
    words, bits = assign_fused_sharded(mesh, rgb_u8, palette_lab, mode, k_active, metric)
    h, w = np.shape(rgb_u8)[:2]
    return unpack_fused_sharded(words, h, w, np.shape(palette_lab)[0],
                                mesh.shape["pixel"]), bits


def meld_fused_sharded(mesh, rgb_u8, palette_lab, k_active=None, metric: str = "cie94",
                       fast: bool = False) -> np.ndarray:
    """The meld pass of the row-sharded image, one meld launch a shard
    (kmeans_tpu/parallel/sharded_ops.py:205): the `[D * M, 128]` int32
    RGB24 host words that `unpack_meld_sharded` inverts. Meld has no row
    phase, so each shard's block is the single-device pass's rows. Any k."""
    palette_lab = _palette(palette_lab, mesh.root)
    blocks, _, _ = _row_sharded(mesh, rgb_u8)
    return np.concatenate(_fetch(_meld_words(blocks, palette_lab, k_active, metric, fast)))


def quantize_image_sharded(mesh, rgba_u8, palette_lab, mode: str = "replace", k_active=None,
                           metric: str = "cie94", fast: bool = False) -> np.ndarray:
    """The `[H, W, 4]` RGBA8 output of the row-sharded image at any palette
    size (kmeans_tpu/parallel/sharded_ops.py:61): replace and dither by the
    assign kernel's colour-out mode a shard (`quantize_rgba`, with its
    `row_offset`), meld by the meld pass and its unpack."""
    palette_lab = _palette(palette_lab, mesh.root)
    blocks, h, local_h = _row_sharded(mesh, rgba_u8)
    w = blocks[0].shape[1]
    if mode == "meld":
        return unpack_meld_sharded(
            _fetch(_meld_words(blocks, palette_lab, k_active, metric, fast)), h, w,
            palette_lab.shape[0], len(blocks))
    if mode not in ("replace", "dither"):
        raise ValueError(f"unknown mode {mode!r}")
    out = np.empty((local_h * len(blocks), w, 4), np.uint8)
    for s, part in enumerate(_fetch(_assign_words(blocks, local_h, palette_lab, mode, k_active,
                                                  metric, fast, colour_out=True))):
        out[s * local_h:(s + 1) * local_h] = part
    return out[:h]


def _shard_blocks(words, n_shards: int) -> list:
    if isinstance(words, (list, tuple)):
        return list(words)
    return np.split(np.asarray(words), n_shards, axis=0)


def unpack_fused_sharded(words, h: int, w: int, kp: int, n_shards: int,
                         palette_rgba=None) -> np.ndarray:
    """Host inverse of `assign_fused_sharded`
    (kmeans_tpu/parallel/sharded_ops.py:283): each shard's block through
    the tile unpack of `quant_tile_rows(kp)` at `local_h` rows, in shard
    order, cropped to `h` rows: the `[h, w]` index map (uint8, or uint16
    for the 16-bit tier). With `palette_rgba` (`[K, 4]` uint8), the
    `[h, w, 4]` RGBA image instead, each shard unpacked and gathered in one
    native pass straight into its rows. `words` is the concatenated array
    or the list of shard blocks."""
    local_h = shard_rows(h, n_shards)
    bits, tile_rows = pack_bits(kp), quant_tile_rows(kp)
    blocks = _shard_blocks(words, n_shards)
    if palette_rgba is None:
        return np.concatenate([unpack_tile_words(b, local_h, w, bits, tile_rows)
                               for b in blocks])[:h]
    out = np.empty((local_h * n_shards, w, 4), np.uint8)
    for s, block in enumerate(blocks):
        unpack_tile_words_gather(block, local_h, w, bits, palette_rgba, tile_rows,
                                 out=out[s * local_h:(s + 1) * local_h])
    return out[:h]


def unpack_meld_sharded(words, h: int, w: int, kp: int, n_shards: int) -> np.ndarray:
    """Host inverse of `meld_fused_sharded`
    (kmeans_tpu/parallel/sharded_ops.py:259): each shard's RGB24 block
    unpacked with `quant_tile_rows(kp)` at `local_h` rows into its rows of
    one `[h, w, 4]` RGBA image (alpha 255), the padding cropped."""
    local_h = shard_rows(h, n_shards)
    out = np.empty((local_h * n_shards, w, 4), np.uint8)
    for s, block in enumerate(_shard_blocks(words, n_shards)):
        unpack_rgb24_tile_words(block, local_h, w, quant_tile_rows(kp),
                                out=out[s * local_h:(s + 1) * local_h])
    return out[:h]
