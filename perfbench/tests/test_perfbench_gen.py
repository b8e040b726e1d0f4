"""The device generator against the definitions of the repository's numpy
generator (src/repro_torch/graph/generators.py), on the CPU at small scales."""
import numpy as np
import pytest
import torch

from perfbench.gen import rmat
from repro_torch.graph import generators

ABC = (0.57, 0.19, 0.19)


def _draw(scale, ef, seed, device="cpu"):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return rmat.rmat_edges(scale, ef, ABC, g)


def test_simple_edges_keeps_first_occurrence_in_stream_order():
    src = torch.tensor([3, 1, 2, 1, 0, 2, 4, 4], dtype=torch.int32)
    dst = torch.tensor([1, 3, 2, 0, 1, 0, 0, 4], dtype=torch.int32)
    s, d = rmat.simple_edges(src, dst, 5)
    # (1,3) repeats (3,1); (2,2), (4,4) are loops; (0,1) repeats (1,0)
    assert list(zip(s.tolist(), d.tolist())) == [(3, 1), (1, 0), (2, 0), (4, 0)]


@pytest.mark.parametrize("scale,ef", [(10, 48), (12, 8), (12, 28)])
def test_edge_count_and_skew_match_the_numpy_definition(scale, ef):
    src, dst = _draw(scale, ef, 2**31 + 5)
    ns, nd = generators.kronecker_graph(scale, edge_factor=ef, seed=3)
    m, m_np = src.shape[0], ns.shape[0]
    assert abs(m - m_np) / m_np < 0.02
    assert (src != dst).all()
    key = torch.minimum(src, dst).long() * (1 << scale) + torch.maximum(src, dst)
    assert torch.unique(key).numel() == m
    deg = torch.bincount(torch.cat([src, dst]).long(), minlength=1 << scale).double()
    deg_np = np.bincount(np.concatenate([ns, nd]), minlength=1 << scale)
    skew, skew_np = (deg.max() / deg.mean()).item(), deg_np.max() / deg_np.mean()
    assert 0.7 < skew / skew_np < 1.4
    # Graph500's a > b = c: low ids are the hubs, as in the numpy generator
    assert deg[: 1 << (scale - 4)].sum() > 4 * deg[-(1 << (scale - 4)):].sum()


def test_weights_in_range_and_uniform():
    g = torch.Generator(device="cpu")
    g.manual_seed(11)
    w = rmat.uniform_weights(200_000, 64, 0.1, 1.0, g)
    hi = rmat.weight_high(64, 0.1)
    assert hi == pytest.approx((1 + 0.1) ** 63 + 1)
    assert w.dtype == torch.float32
    assert w.min().item() >= 1.0 and w.max().item() <= np.float32(hi)
    assert abs(w.double().mean().item() - (1.0 + hi) / 2) < 0.01 * hi
    ref = generators.uniform_weights(200_000, 64, 0.1, seed=4)
    assert abs(np.quantile(ref, 0.25) - torch.quantile(w[:100_000], 0.25).item()) < 0.02 * hi


def test_same_seed_same_stream_other_seed_other():
    cfg = {"edge_factor": 8, "rmat_abc": list(ABC), "L": 16, "eps": 0.1, "weight_low": 1.0}
    a = [rmat.generate(cfg, 9, torch.Generator().manual_seed(2**33 + 1)) for _ in range(2)]
    b = rmat.generate(cfg, 9, torch.Generator().manual_seed(2**33 + 2))
    assert all(torch.equal(x, y) for x, y in zip(*a))
    assert not torch.equal(a[0][2][:100], b[2][:100])
