"""Kronecker/RMAT edge streams with uniform weights, drawn on the device.

The paper (Besta et al., §5.1) evaluates on Kronecker power-law graphs of
the DIMACS-10 / Graph500 family and on real graphs; weights are uniform on
``[1, (1+eps)^(L-1) + 1]`` (§5.1.4). This is that definition in PyTorch,
drawn with one ``torch.Generator`` on the device in a few large calls:

* each of the ``edge_factor * 2^scale`` drawn edges picks one quadrant per
  bit of its ids, with Graph500's probabilities a/b/c/d;
* self-loops go, then duplicates (as undirected pairs), keeping the first
  occurrence in stream order and each kept edge's own orientation;
* weights are float64 uniforms cast to float32, as numpy's ``uniform``.

A graph is a function of its seed alone: the same seed gives the same
stream on the same device type.
"""
from __future__ import annotations

import torch


def rmat_edges(scale: int, edge_factor: int, abc, generator: torch.Generator):
    """(src, dst) int32 tensors on the generator's device, in stream order,
    with self-loops and duplicate pairs removed."""
    a, b, c = (float(x) for x in abc)
    device = generator.device
    n = 1 << scale
    m = edge_factor * n
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    # P(source bit = 1) = c + d; given it, P(destination bit = 1)
    right_p = c + (1.0 - a - b - c)
    down_if_left = b / (a + b)
    down_if_right = (1.0 - a - b - c) / right_p
    for bit in range(scale):
        go_right = torch.rand(m, generator=generator, device=device) < right_p
        r2 = torch.rand(m, generator=generator, device=device)
        go_down = r2 < torch.where(
            go_right,
            torch.tensor(down_if_right, device=device),
            torch.tensor(down_if_left, device=device),
        )
        src |= go_right.to(torch.int32) << bit
        dst |= go_down.to(torch.int32) << bit
        del go_right, go_down, r2
    return simple_edges(src, dst, n)


def simple_edges(src: torch.Tensor, dst: torch.Tensor, n: int):
    """The stream without self-loops and repeated pairs ({u, v} either
    way round): the first occurrence of each pair stays, in stream order."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.minimum(src, dst).to(torch.int64) * n + torch.maximum(src, dst)
    sorted_key, perm = torch.sort(key, stable=True)
    del key
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    del sorted_key
    kept = torch.sort(perm[first]).values
    return src[kept], dst[kept]


def weight_high(L: int, eps: float) -> float:
    """The upper end of the weight range, ``(1+eps)^(L-1) + 1``."""
    return (1.0 + eps) ** (L - 1) + 1.0


def uniform_weights(m: int, L: int, eps: float, low: float, generator: torch.Generator):
    """float32 [m] weights uniform on ``[low, (1+eps)^(L-1) + 1]``."""
    u = torch.rand(m, generator=generator, device=generator.device, dtype=torch.float64)
    return (low + (weight_high(L, eps) - low) * u).to(torch.float32)


def generate(config: dict, scale: int, generator: torch.Generator):
    """One job's stream: (src int32, dst int32, weight float32) on the
    generator's device, for a configuration file's keys ``edge_factor``,
    ``rmat_abc``, ``L``, ``eps`` and ``weight_low``."""
    src, dst = rmat_edges(scale, config["edge_factor"], config["rmat_abc"], generator)
    w = uniform_weights(src.shape[0], config["L"], config["eps"], config["weight_low"], generator)
    return src, dst, w
