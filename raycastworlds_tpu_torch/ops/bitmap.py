"""Bit-packed boolean grids.

Layout (shared with the JAX package): bit ``k = i*W + j`` of a flattened
``[H, W]`` map lands at bit ``k % 32`` of word ``k // 32``.  Torch has no
usable uint32 arithmetic, so device-side words are int32 bit patterns: every
right shift is arithmetic and is followed by ``& 1``.  ``pack_bits_np`` works
in true uint32 on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def n_words(num_bits: int) -> int:
    return (num_bits + 31) // 32


def _bit_weights(device) -> torch.Tensor:
    """int32 [32] with bit q set in entry q (entry 31 is INT32_MIN)."""
    w = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, dtype=torch.int64, device=device
    )
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def pack_bits(bool_map: torch.Tensor) -> torch.Tensor:
    """bool[..., H, W] -> int32[..., ceil(H*W/32)] packed words."""
    h, w = bool_map.shape[-2:]
    lead = bool_map.shape[:-2]
    nb = h * w
    nw = n_words(nb)
    flat = bool_map.reshape(lead + (nb,)).to(torch.int32)
    pad = nw * 32 - nb
    if pad:
        flat = torch.cat(
            [flat, flat.new_zeros(lead + (pad,))], dim=-1
        )
    flat = flat.reshape(lead + (nw, 32))
    # Bits are disjoint, so the OR of the weighted bits is their int32 sum
    # (wrapping at bit 31 gives the same bit pattern).
    return (flat * _bit_weights(bool_map.device)).sum(
        dim=-1, dtype=torch.int32
    )


def unpack_bits(words: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32[..., nw] -> bool[..., H, W]."""
    h, w = shape
    nw = words.shape[-1]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (nw * 32,))[..., : h * w]
    return flat.reshape(words.shape[:-1] + (h, w)).to(torch.bool)


def pack_bits_np(bool_map) -> np.ndarray:
    """Host-side pack to true uint32 words (static maps in configs)."""
    m = np.asarray(bool_map, dtype=bool)
    h, w = m.shape[-2:]
    nb = h * w
    nw = n_words(nb)
    flat = m.reshape(m.shape[:-2] + (nb,)).astype(np.uint32)
    pad = nw * 32 - nb
    if pad:
        flat = np.concatenate(
            [flat, np.zeros(m.shape[:-2] + (pad,), np.uint32)], axis=-1
        )
    flat = flat.reshape(m.shape[:-2] + (nw, 32))
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return np.sum(flat * weights, axis=-1, dtype=np.uint64).astype(np.uint32)


def tiles_to_words(tiles: torch.Tensor, shape, nw: int) -> torch.Tensor:
    """Pack K point tiles per env (i32[B, K, >=2] rows (i, j, ...)) into
    int32[B, nw] occupancy words: K one-hot ORs, no dense map.  Rows with a
    negative i are disabled slots and contribute nothing."""
    _, w = shape
    idx = tiles[..., 0] * w + tiles[..., 1]                     # [B, K]
    lane = torch.arange(nw, dtype=torch.int32, device=tiles.device)
    word_sel = ((idx[..., None] >> 5) == lane) & (tiles[..., 0] >= 0)[..., None]
    bit = torch.ones_like(idx) << (idx & 31)
    contrib = torch.where(word_sel, bit[..., None], 0)          # [B, K, nw]
    out = torch.zeros(contrib.shape[0], nw, dtype=torch.int32, device=tiles.device)
    for q in range(contrib.shape[1]):
        out = out | contrib[:, q]
    return out


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word's uint32 pattern, as int32 (SWAR count
    in int64, where every shift is logical)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101 >> 24) & 0xFF).to(torch.int32)


def lookup_bit(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Test bit ``idx`` of packed words.

    words: int32[B, nw]; idx: int32[B, ...] flattened bit indices (in
    range).  Returns bool[B, ...].
    """
    b = words.shape[0]
    flat_idx = idx.reshape(b, -1).to(torch.int64)
    w = torch.gather(words, 1, flat_idx >> 5)
    bit = ((w >> (flat_idx & 31).to(torch.int32)) & 1) == 1
    return bit.reshape(idx.shape)
