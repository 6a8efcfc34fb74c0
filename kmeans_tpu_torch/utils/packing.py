"""Bit-packed index words: widths and the host-side (numpy) inverse.

Re-implementation of the numpy half of `kmeans_tpu/utils/packing.py`
(`pack_bits:31`, `unpack_tile_words:67`, `unpack_tile_words_gather:102`,
`unpack_rgb24_tile_words:135`, `_unpack_rgb24_np:162`); the port cannot
import that module, because `kmeans_tpu` imports JAX. As in the reference,
`unpack_tile_words_gather` and `unpack_rgb24_tile_words` run the native
runtime's one-pass walks (`kmeans_tpu_torch/runtime/`,
`unpack_indices_gather` and `unpack_rgb24`); the numpy versions
(`_unpack_tile_words_gather_np`, `_unpack_rgb24_np`) are the layouts'
executable spec and the twins the tests hold the native ones to, byte for
byte. Both native unpacks can write into the caller's array (`out=`).

The assign kernel packs `32 // bits` pixel indices into each int32 word.
Word `(tile t, row r < blk, lane l)`, with `blk = tile_rows // ppw`, holds
the pixels `((t * tile_rows) + j * blk + r) * 128 + l` for `j < ppw`, index
`j` at bit `bits * j`.

The meld kernel packs the RGB bytes of 4 pixels into 3 words: with
`blk = tile_rows // 4`, word row `t * 3 * blk + j * blk + r` holds the
pixels `((t * tile_rows) + s * blk + r) * 128 + l`, `s < 4`, low byte
first: `j = 0`: R0 G0 B0 R1; `j = 1`: G1 B1 R2 G2; `j = 2`: B2 R3 G3 B3.
"""

from __future__ import annotations

import numpy as np

from kmeans_tpu_torch import runtime

NIBBLE_PACK_MAX_K = 16
CRUMB_PACK_MAX_K = 4


def pack_bits(k: int) -> int:
    """Bits per packed index for a palette of `k` entries: 2, 4, 8 or 16."""
    if k <= CRUMB_PACK_MAX_K:
        return 2
    if k <= NIBBLE_PACK_MAX_K:
        return 4
    if k <= 256:
        return 8
    return 16


def unpack_tile_words(
    words: np.ndarray,
    h: int,
    w: int,
    bits: int,
    tile_rows: int,
    lanes: int = 128,
) -> np.ndarray:
    """`[M, lanes]` int32 words -> `[h, w]` index map (uint8, or uint16 for
    the 16-bit tier). `tile_rows` must be `ops.kernels.quant_tile_rows(kp)`,
    the tile height the kernel used for this palette size."""
    ppw = 32 // bits
    blk = tile_rows // ppw
    mask = (1 << bits) - 1
    wk = np.ascontiguousarray(words).view(np.uint32)  # logical shifts
    n_tiles = wk.shape[0] // blk
    wk = wk.reshape(n_tiles, blk, lanes)
    idx = np.empty((n_tiles, tile_rows, lanes), np.uint8 if bits <= 8 else np.uint16)
    for j in range(ppw):
        idx[:, blk * j : blk * (j + 1), :] = (wk >> (bits * j)) & mask
    return idx.reshape(-1)[: h * w].reshape(h, w)


def unpack_tile_words_gather(
    words: np.ndarray,
    h: int,
    w: int,
    bits: int,
    palette_rgba: np.ndarray,
    tile_rows: int,
    lanes: int = 128,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """`palette_rgba[unpack_tile_words(...)]`: the `[h, w, 4]` uint8 image
    for a `[K, 4]` uint8 palette, unpacked and gathered in one native pass
    (`runtime.unpack_indices_gather`; an index past the palette raises
    `ValueError`), written into `out` when given (a writable C-contiguous
    uint8 array of at least `h * w * 4` bytes)."""
    return runtime.unpack_indices_gather(words, h, w, bits, tile_rows, lanes, palette_rgba,
                                         out=out)


def _unpack_tile_words_gather_np(
    words: np.ndarray,
    h: int,
    w: int,
    bits: int,
    palette_rgba: np.ndarray,
    tile_rows: int,
    lanes: int = 128,
) -> np.ndarray:
    """Numpy spec of `unpack_tile_words_gather` (numpy raises `IndexError`
    on an index past the palette). The gather moves each pixel as one
    32-bit word, which is byte-equal to gathering `[K, 4]` rows and several
    times faster."""
    idx = unpack_tile_words(words, h, w, bits, tile_rows, lanes)
    pal = np.ascontiguousarray(palette_rgba, dtype=np.uint8).reshape(-1, 4)
    return pal.view(np.uint32).reshape(-1)[idx].view(np.uint8).reshape(h, w, 4)


def unpack_rgb24_tile_words(
    words: np.ndarray,
    h: int,
    w: int,
    tile_rows: int,
    lanes: int = 128,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Invert the meld kernel's RGB byte pack: `[M, lanes]` int32 words ->
    `[h, w, 4]` uint8 RGBA with alpha 255, in one native pass
    (`runtime.unpack_rgb24`), written into `out` when given. `tile_rows`
    must be `ops.kernels.quant_tile_rows(kp)`."""
    return runtime.unpack_rgb24(words, h, w, tile_rows, lanes, out=out)


def _unpack_rgb24_np(
    words: np.ndarray,
    h: int,
    w: int,
    tile_rows: int,
    lanes: int = 128,
) -> np.ndarray:
    """Numpy spec of `unpack_rgb24_tile_words`."""
    blk = tile_rows // 4
    wb = (
        np.ascontiguousarray(words)
        .view(np.uint32)
        .astype("<u4")
        .view(np.uint8)
        .reshape(words.shape[0], lanes, 4)
    )
    n_tiles = words.shape[0] // (3 * blk)
    wb = wb.reshape(n_tiles, 3 * blk, lanes, 4)
    w0, w1, w2 = wb[:, :blk], wb[:, blk : 2 * blk], wb[:, 2 * blk :]
    rgb = np.empty((n_tiles, tile_rows, lanes, 3), np.uint8)
    rgb[:, 0:blk] = w0[..., 0:3]
    rgb[:, blk : 2 * blk, :, 0] = w0[..., 3]
    rgb[:, blk : 2 * blk, :, 1:3] = w1[..., 0:2]
    rgb[:, 2 * blk : 3 * blk, :, 0:2] = w1[..., 2:4]
    rgb[:, 2 * blk : 3 * blk, :, 2] = w2[..., 0]
    rgb[:, 3 * blk :] = w2[..., 1:4]
    flat = rgb.reshape(-1, 3)[: h * w]
    out = np.empty((h * w, 4), np.uint8)
    out[:, :3] = flat
    out[:, 3] = 255
    return out.reshape(h, w, 4)
