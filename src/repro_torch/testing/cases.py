"""Adversarial graph zoo and random RMAT cases as plain numpy.

The nine zoo graphs are those of the JAX package's cross-engine
differential harness (``tests/test_engine_differential.py``): empty
stream, single edge, self-loops, duplicate edges, star/hub, bipartite,
L % 8 != 0, n not a multiple of 8, and a dense graph with weight ties.
A case holds host arrays only, so the same inputs can be handed to any
implementation: ``EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

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
