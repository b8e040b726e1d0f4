"""Graph generators (numpy).

The paper evaluates on DIMACS-10 Kronecker power-law graphs (m ~= 48n) and
KONECT/SNAP real-world graphs, with weights drawn uniformly from
[1, (1+eps)^(L-1)+1] with a fixed seed, as in §5.1.4. Without network
access the real graphs are replaced by RMAT standins of matched (n, m), the
generator family DIMACS uses. Same generators, and the same draws, as
``repro.graph.generators``.
"""
from __future__ import annotations

import numpy as np

#: (n, m) of the paper's Table 5 datasets, for standin generation
PAPER_GRAPHS = {
    "gowalla": (196_591, 950_327),
    "flickr": (2_302_925, 33_140_017),
    "livejournal1": (4_847_571, 68_993_773),
    "orkut": (3_072_441, 117_184_899),
    "stanford": (281_903, 2_312_497),
    "berkeley": (685_230, 7_600_595),
    "arxiv-hep-th": (27_770, 352_807),
}


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


def standin_shape(name: str) -> tuple[int, int]:
    """(Kronecker scale, edge factor) of a paper dataset's standin: the
    least power of two holding its n, and its m over that many vertices."""
    n, m = PAPER_GRAPHS[name]
    scale = int(np.ceil(np.log2(n)))
    return scale, max(1, int(round(m / (1 << scale))))


def real_graph_standin(name: str, seed: int = 0, max_edges: int | None = None):
    """RMAT standin matched to a paper dataset's (n, m), as (src, dst) int64
    arrays over ``2**scale`` vertices (:func:`standin_shape`); ``max_edges``
    keeps a prefix."""
    scale, ef = standin_shape(name)
    src, dst = kronecker_graph(scale, edge_factor=ef, seed=seed)
    if max_edges is not None and src.shape[0] > max_edges:
        src, dst = src[:max_edges], dst[:max_edges]
    return src, dst


def uniform_weights(m: int, L: int, eps: float, seed: int = 0) -> np.ndarray:
    """Weights uniform in [1, (1+eps)^(L-1) + 1] with fixed seed (§5.1.4)."""
    rng = np.random.default_rng(seed)
    hi = (1.0 + eps) ** (L - 1) + 1.0
    return rng.uniform(1.0, hi, m).astype(np.float32)
