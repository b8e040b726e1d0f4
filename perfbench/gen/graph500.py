"""Graph500's Kronecker edge list, drawn on the device, with the paper's
weights.

The Graph500 specification (graph500.org, Sec. 3 "Graph Generation") fixes
the generator by its Octave listing ``kronecker_generator``:

* ``M = edgefactor * 2^SCALE`` edges, each with SCALE bits per endpoint,
  one quadrant per bit with the initiator probabilities A/B/C/D;
* the vertex labels permuted at random (``p = randperm(N); ij = p(ij)``);
* the edge order permuted at random (``ij = ij(:, randperm(M))``);
* self-loops and repeated edges kept: "may be ignored in the subsequent
  kernels but must be included in the edge list".

This is that listing in PyTorch, drawn with one ``torch.Generator`` on its
device in a few large calls: the bits, then the label permutation, the
edge permutation and the weights, in that order. The weights are the
paper's (uniform on ``[low, (1+eps)^(L-1) + 1]``, :mod:`perfbench.gen.rmat`),
not Graph500's SSSP weights on [0, 1), which lie below the first threshold.

A graph is a function of its seed alone: the same seed gives the same
stream on the same device type.
"""
from __future__ import annotations

import torch

from perfbench.gen import rmat


def kronecker_bits(scale: int, edge_factor: int, abc, generator: torch.Generator):
    """(src, dst) int32 tensors of the listing's loop over the bits, before
    any permutation: vertex ``k`` is the listing's ``k + 1``."""
    a, b, c = (float(x) for x in abc)
    device = generator.device
    m = edge_factor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        ii_bit = torch.rand(m, generator=generator, device=device) > ab
        r = torch.rand(m, generator=generator, device=device)
        jj_bit = r > torch.where(ii_bit, c_norm, a_norm)
        src |= ii_bit.to(torch.int32) << bit
        dst |= jj_bit.to(torch.int32) << bit
        del ii_bit, jj_bit, r
    return src, dst


def kronecker_edges(scale: int, edge_factor: int, abc, generator: torch.Generator):
    """(src, dst) int32: :func:`kronecker_bits`, its labels permuted by one
    ``randperm(2^scale)``, then its order by one ``randperm(M)``. Every
    self-loop and repeated pair stays."""
    src, dst = kronecker_bits(scale, edge_factor, abc, generator)
    device = generator.device
    label = torch.randperm(1 << scale, generator=generator, device=device).to(torch.int32)
    src = torch.index_select(label, 0, src)
    dst = torch.index_select(label, 0, dst)
    del label
    order = torch.randperm(src.shape[0], generator=generator, device=device)
    return torch.index_select(src, 0, order), torch.index_select(dst, 0, order)


def generate(config: dict, scale: int, generator: torch.Generator):
    """One job's stream: (src int32, dst int32, weight float32) on the
    generator's device, exactly ``edge_factor * 2^scale`` edges, for a
    configuration file's keys ``edge_factor``, ``rmat_abc``, ``L``, ``eps``
    and ``weight_low``."""
    src, dst = kronecker_edges(scale, config["edge_factor"], config["rmat_abc"], generator)
    w = rmat.uniform_weights(src.shape[0], config["L"], config["eps"], config["weight_low"],
                             generator)
    return src, dst, w
