"""Bit-packed index words: widths and the host-side (numpy) inverse.

Re-implementation of the numpy half of `kmeans_tpu/utils/packing.py`
(`pack_bits:31`, `unpack_tile_words:67`, `unpack_tile_words_gather:102`);
the port cannot import that module, because `kmeans_tpu` imports JAX.

The assign kernel packs `32 // bits` pixel indices into each int32 word.
Word `(tile t, row r < blk, lane l)`, with `blk = tile_rows // ppw`, holds
the pixels `((t * tile_rows) + j * blk + r) * 128 + l` for `j < ppw`, index
`j` at bit `bits * j`.
"""

from __future__ import annotations

import numpy as np

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
) -> np.ndarray:
    """`palette_rgba[unpack_tile_words(...)]`: the `[h, w, 4]` uint8 image
    for a `[K, 4]` uint8 palette (numpy raises `IndexError` on an index
    past the palette). The gather moves each pixel as one 32-bit word,
    which is byte-equal to gathering `[K, 4]` rows and several times
    faster."""
    idx = unpack_tile_words(words, h, w, bits, tile_rows, lanes)
    pal = np.ascontiguousarray(palette_rgba, dtype=np.uint8).reshape(-1, 4)
    return pal.view(np.uint32).reshape(-1)[idx].view(np.uint8).reshape(h, w, 4)
