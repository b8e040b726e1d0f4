"""Data pipelines of the port (the JAX package's ``repro.data``)."""
from repro_torch.data.pipeline import (
    GraphStreamPipeline,
    RecsysPipeline,
    TokenPipeline,
    make_gnn_batch,
)

__all__ = [
    "TokenPipeline",
    "GraphStreamPipeline",
    "RecsysPipeline",
    "make_gnn_batch",
]
