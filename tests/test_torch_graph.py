"""Port parity of the graph substrate: the paper-dataset standins, CSR and
the paper's custom §4.3 layout (byte for byte), the partitioners,
coarsening by matching (Part 1 through the per-edge kernel's plain version
on the CPU) and the neighbor sampler, each exactly equal to the JAX
package's ``repro.graph`` on the same numpy inputs; the segment ops against
``jax.ops`` within rtol 1e-6 (float32 sums, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graph as jgraph
from repro_torch import graph
from repro_torch.core import SubstreamConfig
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel

SEGMENT_RTOL = 1e-6


def test_paper_graphs_match_reference():
    assert graph.PAPER_GRAPHS == jgraph.generators.PAPER_GRAPHS


@pytest.mark.parametrize("max_edges", [None, 1, 5_000])
@pytest.mark.parametrize("name", ["arxiv-hep-th", "stanford"])
def test_real_graph_standin_matches_reference(name, max_edges):
    got = graph.real_graph_standin(name, seed=3, max_edges=max_edges)
    want = jgraph.real_graph_standin(name, seed=3, max_edges=max_edges)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    if max_edges is not None:
        assert got[0].shape == (max_edges,)
    scale, _ = graph.generators.standin_shape(name)
    assert got[0].max() < 1 << scale and (1 << scale) >= graph.PAPER_GRAPHS[name][0]


def _edges(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m), rng.integers(0, n, m),
            rng.uniform(1, 10, m).astype(np.float32))


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("n, m, seed", [(1, 0, 0), (7, 1, 1), (11, 40, 2), (50, 200, 3),
                                         (257, 1_000, 4)])
def test_csr_and_custom_csr_match_reference(n, m, seed, symmetrize):
    src, dst, w = _edges(seed, n, m)
    csr = graph.CSRGraph.from_edges(src, dst, w, n=n, symmetrize=symmetrize)
    ref = jgraph.CSRGraph.from_edges(src, dst, w, n=n, symmetrize=symmetrize)
    for f in ("row", "col", "val"):
        got, want = getattr(csr, f), getattr(ref, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (csr.n, csr.m) == (ref.n, ref.m)
    for a, b in zip(csr.to_stream_arrays(), ref.to_stream_arrays()):
        np.testing.assert_array_equal(a, b)
    for u in range(min(n, 5)):
        for a, b in zip(csr.neighbors(u), ref.neighbors(u)):
            np.testing.assert_array_equal(a, b)
    cc, jcc = graph.CustomCSR.encode(csr), jgraph.CustomCSR.encode(ref)
    assert cc.pointer_data.tobytes() == jcc.pointer_data.tobytes()
    assert cc.graph_data.tobytes() == jcc.graph_data.tobytes()
    assert (cc.n, cc.m, cc.dram_bytes) == (jcc.n, jcc.m, jcc.dram_bytes)
    assert cc.read_requests_per_edge() == jcc.read_requests_per_edge() == 1.125
    back = cc.decode()
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(back, f), getattr(csr, f))
        np.testing.assert_array_equal(getattr(back, f), getattr(jcc.decode(), f))


@pytest.mark.parametrize("pad_to_multiple", [1, 8])
@pytest.mark.parametrize("num_parts", [1, 2, 3, 8])
@pytest.mark.parametrize("m", [0, 5, 64, 101])
def test_partitions_match_reference(m, num_parts, pad_to_multiple):
    src, dst, w = _edges(m, 30, m)
    got = graph.partition_edges(src, dst, w, num_parts, pad_to_multiple)
    want = jgraph.partition_edges(src, dst, w, num_parts, pad_to_multiple)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert graph.partition_vertices(m + 7, num_parts) == jgraph.partition_vertices(m + 7, num_parts)


@pytest.mark.parametrize("L", [16, 32])
@pytest.mark.parametrize("scale, edge_factor, seed", [(6, 4, 0), (8, 8, 1), (10, 4, 2)])
def test_coarsen_by_matching_matches_reference(scale, edge_factor, seed, L):
    """Part 1 through ``substream_match`` (the per-edge kernel's plain
    version on the CPU) gives the reference's ``mwm_scan`` bits, so the
    coarse graph is the reference's."""
    n = 1 << scale
    jthr = np.asarray(jax.jit(jcore.SubstreamConfig(n=n, L=L, eps=0.1).thresholds)())
    np.testing.assert_array_equal(SubstreamConfig(n, L, 0.1).thresholds(), jthr)
    src, dst = graph.kronecker_graph(scale, edge_factor, seed=seed)
    w = graph.uniform_weights(src.shape[0], L, 0.1, seed=seed)
    before = build.launches[kernel.NAME]
    got = graph.coarsen_by_matching(src, dst, w, n, L=L, device="cpu")
    assert build.launches[kernel.NAME] == before  # the CPU runs the plain version
    want = jgraph.coarsen_by_matching(src, dst, w, n, L=L)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0].max() + 1 < n  # something was contracted


@pytest.mark.parametrize("edges", [[], [(1, 3)], [(0, 1), (1, 0), (2, 2)]])
def test_coarsen_without_coarse_edges(edges):
    """A graph whose edges all vanish (none, or all inside a cluster) gives
    empty coarse arrays. The reference raises there (``np.add.at`` on a
    group it made up, ROADMAP.md §3); pinned."""
    src = np.array([u for u, _ in edges], np.int64)
    dst = np.array([v for _, v in edges], np.int64)
    w = np.full(len(edges), 2.0, np.float32)
    mapping, lo, hi, cw = graph.coarsen_by_matching(src, dst, w, 5, device="cpu")
    assert lo.size == hi.size == cw.size == 0 and cw.dtype == np.float32
    assert mapping.shape == (5,) and mapping.max() == 4 - (len(edges) > 0)
    with pytest.raises(ValueError, match="broadcast"):
        jgraph.coarsen_by_matching(src, dst, w, 5)


def _segment_inputs(dtype, shape, num_segments, seed):
    rng = np.random.default_rng(seed)
    m = shape[0]
    ids = rng.integers(0, num_segments - 3, m).astype(np.int32)  # the last 3 stay empty
    if np.dtype(dtype).kind == "f":
        data = rng.normal(size=shape).astype(dtype)
    else:
        data = rng.integers(-1000, 1000, shape).astype(dtype)
    return data, ids


def _close(got: torch.Tensor, want, rtol=SEGMENT_RTOL):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", [(300,), (300, 5), (64, 3, 2)])
@pytest.mark.parametrize("op", ["segment_sum", "segment_max", "segment_mean"])
def test_segment_ops_match_jax(op, shape, dtype):
    num = 40
    data, ids = _segment_inputs(dtype, shape, num, seed=len(shape))
    got = getattr(graph, op)(torch.from_numpy(data), torch.from_numpy(ids), num)
    want = getattr(jgraph, op)(jnp.asarray(data), jnp.asarray(ids), num)
    _close(got, want)
    if op == "segment_max":  # empty segments: -inf, or the integer type's least value
        lowest = -np.inf if dtype == np.float32 else np.iinfo(dtype).min
        assert (got.numpy()[-3:] == lowest).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_softmax_and_messages_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, m = 50, 400
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n - 5, m).astype(np.int32)  # the last 5 receive nothing
    scores = rng.normal(size=m).astype(np.float32) * 4
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    t = torch.from_numpy
    _close(graph.segment_softmax(t(scores), t(dst), n),
           jgraph.segment_softmax(jnp.asarray(scores), jnp.asarray(dst), n))
    for reduce in ("sum", "mean", "max"):
        _close(graph.scatter_messages(t(feats), t(src), t(dst), n, reduce=reduce),
               jgraph.scatter_messages(jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), n,
                                       reduce=reduce))
    _close(graph.degrees(t(src), t(dst), n),
           jgraph.degrees(jnp.asarray(src), jnp.asarray(dst), n))
    with pytest.raises(ValueError):
        graph.scatter_messages(t(feats), t(src), t(dst), n, reduce="prod")


@pytest.mark.parametrize("fanouts", [(3,), (4, 2), (15, 10)])
@pytest.mark.parametrize("seed", [0, 5])
def test_neighbor_sampler_matches_reference(seed, fanouts):
    src, dst = graph.kronecker_graph(8, edge_factor=4, seed=seed)
    w = graph.uniform_weights(len(src), 8, 0.1, seed=seed)
    n = 256
    csr = graph.CSRGraph.from_edges(src, dst, w, n=n, symmetrize=True)
    jcsr = jgraph.CSRGraph.from_edges(src, dst, w, n=n, symmetrize=True)
    seeds = np.random.default_rng(seed).choice(n, 12, replace=False)
    sampler = graph.NeighborSampler(csr, fanouts, seed=seed)
    ref = jgraph.NeighborSampler(jcsr, fanouts, seed=seed)
    for _ in range(2):  # the generator's state carries over between calls
        got, want = sampler.sample(seeds), ref.sample(seeds)
        assert len(got) == len(want) == len(fanouts)
        for a, b in zip(got, want):
            assert isinstance(a, graph.SampledBlock) and a.num_dst == b.num_dst
            for f in ("src_index", "dst_index", "edge_mask", "nodes", "node_mask"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
