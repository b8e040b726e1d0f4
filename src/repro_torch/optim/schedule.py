"""LR schedules, float32 as the JAX package computes them. WSD
(warmup-stable-decay) is MiniCPM's contribution (arXiv:2404.06395)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def wsd_schedule(step, peak_lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    in_decay = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
    decay_mult = torch.exp(torch.log(_f32(final_frac)) * in_decay)  # exponential decay leg
    return torch.where(step < warmup + stable, warm, peak_lr * decay_mult)


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)
