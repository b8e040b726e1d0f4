"""Graph substrate of the port: generators (with the paper's dataset
standins), CSR (incl. the paper's custom layout), segment-op message
passing, neighbor sampling, partitioning, coarsening, and the wave
scheduler."""
from repro_torch.graph.generators import (
    PAPER_GRAPHS,
    kronecker_graph,
    real_graph_standin,
    uniform_weights,
)
from repro_torch.graph.csr import CSRGraph, CustomCSR
from repro_torch.graph.segment import (
    segment_sum,
    segment_mean,
    segment_max,
    segment_softmax,
    scatter_messages,
    degrees,
)
from repro_torch.graph.sampler import NeighborSampler, SampledBlock
from repro_torch.graph.partition import partition_edges, partition_vertices
from repro_torch.graph.coarsen import coarsen_by_matching
from repro_torch.graph.waves import WaveSchedule, wave_schedule

__all__ = [
    "PAPER_GRAPHS",
    "kronecker_graph",
    "uniform_weights",
    "real_graph_standin",
    "CSRGraph",
    "CustomCSR",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_softmax",
    "scatter_messages",
    "degrees",
    "NeighborSampler",
    "SampledBlock",
    "partition_edges",
    "partition_vertices",
    "coarsen_by_matching",
    "WaveSchedule",
    "wave_schedule",
]
