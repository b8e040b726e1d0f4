"""Bit-packing of the matching-bit block (§4.3's BRAM word).

Each vertex's matching state is one L-bit word, stored as uint8 bit
planes::

    mb_packed[v, k] : uint8, bit j of word k  ==  substream 8*k + j of v

Substream ``i`` lives at byte ``i // 8``, bit ``i % 8`` (LSB first).
``L`` need not divide 8; the high bits of the last byte are always zero.
Same layout as ``repro.core.bitpack``.
"""
from __future__ import annotations

import torch

BITS = 8  # bits per packed word (uint8 lanes)


def packed_width(L: int) -> int:
    """Number of uint8 words holding L substream bits: ceil(L / 8)."""
    return -(-L // BITS)


def pack_bits(mb: torch.Tensor) -> torch.Tensor:
    """bool/int [..., L] -> uint8 [..., ceil(L/8)], LSB-first bit planes."""
    L = mb.shape[-1]
    W = packed_width(L)
    x = mb.to(torch.uint8)
    pad = W * BITS - L
    if pad:
        x = torch.cat([x, x.new_zeros(mb.shape[:-1] + (pad,))], dim=-1)
    x = x.reshape(mb.shape[:-1] + (W, BITS))
    weights = torch.tensor([1 << j for j in range(BITS)], dtype=torch.int32, device=mb.device)
    return (x.to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, L: int) -> torch.Tensor:
    """uint8 [..., W] -> bool [..., L]; inverse of :func:`pack_bits`."""
    W = packed.shape[-1]
    if W < packed_width(L):
        raise ValueError(f"{W} words cannot hold {L} bits")
    shifts = torch.arange(BITS, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (W * BITS,))[..., :L].to(torch.bool)
