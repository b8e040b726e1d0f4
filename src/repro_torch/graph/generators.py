"""Graph generators (numpy).

The paper evaluates on DIMACS-10 Kronecker power-law graphs (m ~= 48n),
with weights drawn uniformly from [1, (1+eps)^(L-1)+1] with a fixed seed,
as in §5.1.4. Same generators, and the same draws, as
``repro.graph.generators``.
"""
from __future__ import annotations

import numpy as np


def kronecker_graph(
    scale: int,
    edge_factor: int = 48,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
):
    """RMAT/Kronecker generator (Graph500 parameters; DIMACS-10 family).

    Returns (src, dst) int64 arrays with self-loops and duplicates removed
    (duplicates are removed to keep exact-oracle comparisons clean; the
    matcher itself tolerates both).
    """
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        go_right = r > ab  # bottom half for source
        r2 = rng.random(m)
        thresh = np.where(go_right, c / (c + (1 - abc)), a / ab)
        go_down = r2 > thresh
        src |= go_right.astype(np.int64) << bit
        dst |= go_down.astype(np.int64) << bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # canonicalize + dedupe
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * n + hi
    _, uniq = np.unique(key, return_index=True)
    uniq.sort()
    return src[uniq], dst[uniq]


def uniform_weights(m: int, L: int, eps: float, seed: int = 0) -> np.ndarray:
    """Weights uniform in [1, (1+eps)^(L-1) + 1] with fixed seed (§5.1.4)."""
    rng = np.random.default_rng(seed)
    hi = (1.0 + eps) ** (L - 1) + 1.0
    return rng.uniform(1.0, hi, m).astype(np.float32)
