"""Gradient compression: int8 blockwise quantization with error feedback
(EF-SGD style, Karimireddy et al. 2019), the JAX package's
``repro.optim.compression``: blocks of 256 values, one float32 scale
(the block's largest magnitude / 127) each, rounded half to even as
``jnp.round`` is."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def compress_int8(x: torch.Tensor):
    """x -> (q int8 [n_pad / BLOCK, BLOCK], scale f32 [n_pad / BLOCK], shape)."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, _pad_len(n) - n))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)[:, None]).to(torch.int8)
    return q, scale, tuple(x.shape)


def decompress_int8(q, scale, shape, dtype=torch.float32):
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape).to(dtype)


@dataclasses.dataclass
class ErrorFeedback:
    """Stateless helpers; the residual lives in the caller's state."""

    @staticmethod
    def init(params: dict) -> dict:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    @staticmethod
    def compress_with_feedback(grad, residual):
        """(grad, residual) -> (q, scale, shape, new_residual)."""
        corrected = grad.float() + residual
        q, scale, shape = compress_int8(corrected)
        recon = decompress_int8(q, scale, shape)
        return q, scale, shape, corrected - recon
