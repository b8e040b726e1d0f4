"""Plain PyTorch versions of the substream_match kernel.

Semantics = Listing 1 Part 1 over the edge order given: the kernel
processes edges exactly in the order it receives them, like the FPGA
pipeline processes the merged stream. The caller pre-sorts into the
blocked lexicographic order. Both run where their tensors lie; the CUDA
kernel is held to :func:`substream_match_ref_packed` on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.core.matching import greedy_scan, highest_lane


def substream_match_ref(
    src: torch.Tensor,  # int32 [m]
    dst: torch.Tensor,  # int32 [m]
    weight: torch.Tensor,  # float [m]; <= 0 encodes padding/invalid
    thresholds: torch.Tensor,  # float32 [L]
    n: int,
    mb0: torch.Tensor | None = None,  # int8/bool [n, L] carried-in bits
):
    """Dense oracle. Returns (assigned int32 [m], mb int8 [n, L]); ``mb0``
    seeds the matching bits, default zeros."""
    L = thresholds.shape[0]
    te = (weight.to(torch.float32)[:, None] >= thresholds) & (src != dst)[:, None]
    mb = (
        torch.zeros((n, L), dtype=torch.bool, device=src.device)
        if mb0 is None
        else mb0.to(torch.int8).ne(0)
    )
    added = greedy_scan(te, src, dst, mb)
    return highest_lane(added), mb.to(torch.int8)


def substream_match_ref_packed(
    src: torch.Tensor,  # int32 [m]
    dst: torch.Tensor,  # int32 [m]
    weight: torch.Tensor,  # float [m]; <= 0 encodes padding/invalid
    thresholds: torch.Tensor,  # float32 [L]
    n: int,
    mb0: torch.Tensor | None = None,  # uint8 [n, ceil(L/8)] carried-in bits
):
    """Packed-word oracle: the same scan, but the state is the uint8
    bit-plane word of :mod:`repro_torch.core.bitpack` and every per-edge
    update is a bitwise op on ceil(L/8) words.

    Returns (assigned int32 [m], mb_packed uint8 [n, ceil(L/8)]).
    """
    dev = src.device
    L = thresholds.shape[0]
    W = bitpack.packed_width(L)
    thr_flat = torch.full((W * bitpack.BITS,), float("inf"), dtype=torch.float32, device=dev)
    thr_flat[:L] = thresholds
    thr_bits = thr_flat.reshape(W, bitpack.BITS)  # [k, j] = substream 8k+j
    bitval = torch.tensor([1 << j for j in range(bitpack.BITS)], dtype=torch.int32, device=dev)
    planes = (weight.to(torch.float32)[:, None, None] >= thr_bits) & (src != dst)[:, None, None]
    te = (planes.to(torch.int32) * bitval).sum(dim=-1).to(torch.uint8)  # [m, W]
    mb = (
        torch.zeros((n, W), dtype=torch.uint8, device=dev)
        if mb0 is None
        else mb0.to(torch.uint8).clone()
    )
    added = greedy_scan(te, src, dst, mb)
    shifts = torch.arange(bitpack.BITS, dtype=torch.uint8, device=dev)
    hit = ((added[:, :, None] >> shifts) & 1).bool()  # [m, W, 8]
    return highest_lane(hit.reshape(added.shape[0], W * bitpack.BITS)), mb
