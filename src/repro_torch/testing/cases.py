"""Adversarial graph zoo and random RMAT cases as plain numpy.

The nine zoo graphs are those of the JAX package's cross-engine
differential harness (``tests/test_engine_differential.py``): empty
stream, single edge, self-loops, duplicate edges, star/hub, bipartite,
L % 8 != 0, n not a multiple of 8, and a dense graph with weight ties.
``WINDOW`` adds streams aimed at the per-edge kernels' batches of 32 edges
and their window (the previous batch and the earlier lanes): a hub, pairs
that come back 31 to 65 edges later, self-loops inside a batch, and
streams of 0, 1, 31, 32 and 33 edges. ``WAVE`` adds streams aimed at the
wave kernels' slot ring and passes: two waves of 5,000 disjoint edges
(wider than the ring and than one pass of 512 slots), a star of 3,000
leaves (3,000 one-edge waves), and waves of mixed widths on both sides of
the ring's capacity. A case holds host arrays only, so the same inputs can
be handed to any implementation:
``EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)``. Last come
three ways to perturb a kernel's operands that its result must not see:
:func:`with_pad_bits`, :func:`permuted_lanes` and :func:`at_offset`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.graph.generators import kronecker_graph, uniform_weights


class Case(NamedTuple):
    n: int
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    L: int
    eps: float
    pad: int  # invalid padding edges appended to the stream

    @property
    def m_pad(self) -> int:
        return self.src.shape[0] + self.pad


def _from_lists(n, edges, L=16, eps=0.1, pad=0) -> Case:
    if edges:
        src, dst, w = (np.asarray(x) for x in zip(*edges))
    else:
        src = dst = np.zeros(0, np.int32)
        w = np.zeros(0, np.float32)
    return Case(n, src, dst, w, L, eps, pad)


def _zoo_empty():
    return _from_lists(8, [])


def _zoo_single_edge():
    return _from_lists(5, [(1, 3, 2.5)])


def _zoo_self_loops():
    # every edge a self-loop except one real edge buried in the middle
    edges = [(i % 6, i % 6, 3.0 + i) for i in range(9)]
    edges.insert(4, (0, 5, 4.0))
    return _from_lists(6, edges)


def _zoo_duplicates():
    # the same edge many times, with ties and near-ties in weight
    edges = [(2, 7, 5.0)] * 6 + [(7, 2, 5.0)] * 3 + [(2, 7, 1.5), (1, 2, 5.0)]
    return _from_lists(9, edges, L=9)  # L % 8 != 0 on top


def _zoo_star():
    # hub 0: only one incident edge can ever match per substream
    rng = np.random.default_rng(3)
    edges = [(0, i, float(w)) for i, w in zip(range(1, 33), rng.uniform(1, 30, 32))]
    return _from_lists(33, edges, L=24)


def _zoo_bipartite():
    rng = np.random.default_rng(7)
    left = rng.integers(0, 16, 120)
    right = rng.integers(16, 32, 120)
    w = rng.uniform(1.0, 25.0, 120).astype(np.float32)
    return _from_lists(32, list(zip(left, right, w)), L=32, pad=13)


def _zoo_unaligned_L():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 37, 90)
    dst = rng.integers(0, 37, 90)  # self-loops + duplicates allowed
    w = rng.uniform(0.5, 40.0, 90).astype(np.float32)
    return _from_lists(37, list(zip(src, dst, w)), L=13)


def _zoo_unaligned_n():
    # n=257 (not a multiple of 8 or any block size), m prime
    rng = np.random.default_rng(13)
    src = rng.integers(0, 257, 211)
    dst = rng.integers(0, 257, 211)
    w = rng.uniform(1.0, 60.0, 211).astype(np.float32)
    return _from_lists(257, list(zip(src, dst, w)), L=17, pad=5)


def _zoo_dense_small():
    # dense graph: long waves, lots of conflicts, weight ties
    edges = [
        (u, v, float(1 + ((u * 7 + v) % 5)))
        for u in range(10)
        for v in range(10)
        if u != v
    ]
    return _from_lists(10, edges, L=8)


ZOO = {
    "empty": _zoo_empty,
    "single_edge": _zoo_single_edge,
    "self_loops": _zoo_self_loops,
    "duplicates": _zoo_duplicates,
    "star": _zoo_star,
    "bipartite": _zoo_bipartite,
    "unaligned_L": _zoo_unaligned_L,
    "unaligned_n": _zoo_unaligned_n,
    "dense_small": _zoo_dense_small,
}


def rmat_case(scale: int, edge_factor: int = 8, L: int = 16, eps: float = 0.1,
              seed: int = 0, pad: int = 0) -> Case:
    """Kronecker graph on 2^scale vertices with §5.1.4's uniform weights."""
    src, dst = kronecker_graph(scale, edge_factor=edge_factor, seed=seed)
    w = uniform_weights(src.shape[0], L, eps, seed=seed)
    return Case(1 << scale, src, dst, w, L, eps, pad)


def window_eps(L: int) -> float:
    """An eps that keeps the top weight (1+eps)^(L-1) moderate at ``L``."""
    return 0.1 if L <= 65 else (0.01 if L <= 300 else 0.002)


def _window_case(n, src, dst, L, seed):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    eps = window_eps(L)
    return Case(n, src, dst, uniform_weights(src.shape[0], L, eps, seed=seed), L, eps, 0)


def _window_hub(L=64):
    # vertex 0 on every other edge, as u and as v in turn; the rest random
    rng = np.random.default_rng(21)
    n, m = 96, 300
    a, b = rng.integers(1, n, m), rng.integers(1, n, m)
    i = np.arange(m)
    src = np.where(i % 4 == 0, 0, a)
    dst = np.where(i % 4 == 2, 0, b)
    return _window_case(n, src, dst, L, seed=21)


def _window_repeats(distance, L=64):
    # the pair of edge i comes back at i + distance for every 5th i, swapped every other time
    rng = np.random.default_rng(distance)
    n, m = 48, 200
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    for k, i in enumerate(range(0, m - distance, 5)):
        a, b = (src[i], dst[i]) if k % 2 else (dst[i], src[i])
        src[i + distance], dst[i + distance] = a, b
    return _window_case(n, src, dst, L, seed=distance)


def _window_self_loops(L=64):
    # self-loops at the batch bounds and inside batches, on vertices their neighbours touch
    rng = np.random.default_rng(5)
    n, m = 40, 160
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    for i in (3, 17, 31, 32, 33, 50, 63, 64, 100, 101):
        src[i] = dst[i] = src[i - 1]
    return _window_case(n, src, dst, L, seed=5)


def _window_short(m, L=64):
    # few vertices, so the edges of a short stream conflict
    rng = np.random.default_rng(m)
    return _window_case(12, rng.integers(0, 12, m), rng.integers(0, 12, m), L, seed=m)


WINDOW = {
    "hub": _window_hub,
    **{f"repeat_d{d}": (lambda L=64, d=d: _window_repeats(d, L)) for d in (31, 32, 33, 63, 64, 65)},
    "self_loops_mid": _window_self_loops,
    **{f"m{m}": (lambda L=64, m=m: _window_short(m, L)) for m in (0, 1, 31, 32, 33)},
}


def _rounds(widths, L, seed):
    # round b is a matching of widths[b] edges on the vertices 0..2*widths[b], shifted by one
    # every other round, so it conflicts with the round before: one wave a round, mostly
    src, dst = [], []
    for b, w in enumerate(widths):
        x = 2 * np.arange(w) + b % 2
        src.append(x)
        dst.append(x + 1)
    n = 2 * max(widths) + 2
    return _window_case(n, np.concatenate(src), np.concatenate(dst), L, seed)


def _wave_wide(L=64):
    # two waves of 5,000 disjoint edges, then 60 edges on a few vertices (short waves)
    rng = np.random.default_rng(31)
    c = _rounds([5000, 5000], L, seed=31)
    src = np.concatenate([c.src, rng.integers(0, 40, 60).astype(np.int32)])
    dst = np.concatenate([c.dst, rng.integers(0, 40, 60).astype(np.int32)])
    return _window_case(c.n, src, dst, L, seed=31)


def _wave_star(L=64, leaves=3000):
    # hub 0 on every edge, as u and as v in turn: one wave per edge
    i = np.arange(1, leaves + 1)
    src = np.where(i % 2 == 0, 0, i)
    dst = np.where(i % 2 == 0, i, 0)
    return _window_case(leaves + 1, src, dst, L, seed=37)


def _wave_mixed(L=64):
    # one wave per round: every edge of a round takes one endpoint of the round before and one
    # new vertex, so widths may double from round to round; they cross the ring's capacity
    # (4,096 slots at L <= 64) both ways
    widths = [64, 128, 256, 512, 1024, 2048, 4096, 5000, 30, 60, 120, 240, 480, 960, 1920,
              3840, 7, 3]
    rng = np.random.default_rng(41)
    src, dst, prev, n = [], [], np.zeros(0, np.int64), 0
    for w in widths:
        old = prev[rng.permutation(prev.size)[:w]] if prev.size else np.arange(n, n + w) + w
        new = np.arange(n, n + w)
        n += w if prev.size else 2 * w
        swap = np.arange(w) % 2 == 1
        src.append(np.where(swap, new, old))
        dst.append(np.where(swap, old, new))
        prev = np.concatenate([old, new])
    return _window_case(n, np.concatenate(src), np.concatenate(dst), L, seed=41)


WAVE = {"wide": _wave_wide, "star": _wave_star, "mixed": _wave_mixed}


# --------------------------------------------------------------------------
# Operand perturbations for the kernels' checks.


def with_pad_bits(block: torch.Tensor, n: int, L: int, seed: int = 3):
    """A packed block uint8 [rows, width] with random bits set outside the n
    vertices' L substreams (rows past n, bits past L), and the mask of those
    bits: a kernel must hand them back as they came."""
    bits = torch.ones((block.shape[0], 8 * block.shape[1]), dtype=torch.bool)
    bits[:n, :L] = False
    mask = bitpack.pack_bits(bits).to(block.device)
    noise = torch.randint(0, 256, tuple(block.shape), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(seed)).to(block.device)
    return block | (noise & mask), mask


def permuted_lanes(thresholds: torch.Tensor, L: int, seed: int = 5) -> torch.Tensor:
    """The waves kernel's thresholds with their first L lanes in a random
    order: bit planes [8, width] (lane 8k+j = thr[j, k]) or lanes [1, width]."""
    flat = thresholds.t().reshape(-1).clone()
    perm = torch.randperm(L, generator=torch.Generator().manual_seed(seed)).to(flat.device)
    flat[:L] = flat[perm]
    return flat.reshape(thresholds.shape[::-1]).t().contiguous()


def at_offset(t: torch.Tensor, lead: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``lead`` elements into its own
    allocation, so off the alignment an allocation has."""
    big = torch.zeros(t.numel() + lead, dtype=t.dtype, device=t.device)
    view = big[lead:].view(t.shape)
    view.copy_(t)
    return view
