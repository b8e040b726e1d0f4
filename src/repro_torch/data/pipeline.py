"""Deterministic, restartable data pipelines.

Every pipeline is seeded and indexed by *global step*, so restart-from-
checkpoint resumes the exact batch sequence (data state is derived, never
stored). Synthetic sources stand in for real corpora. numpy underneath,
with the JAX package's draws for the same seed (``repro.data.pipeline``);
the batches are torch tensors on ``device`` (None: the CUDA card).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import kronecker_graph, uniform_weights
from repro_torch.models.gnn_common import GraphBatch


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    device: Any = None

    def batch_at(self, step: int) -> torch.Tensor:
        """int32 [batch, seq_len] zipf-ish tokens of ``step``."""
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.3, size=(self.batch, self.seq_len))
        return torch.from_numpy((z % self.vocab).astype(np.int32)).to(resolve_device(self.device))


@dataclasses.dataclass
class GraphStreamPipeline:
    """Streams a Kronecker graph's edges in epoch blocks (paper workload)."""

    scale: int
    edge_factor: int
    L: int
    eps: float
    seed: int = 0

    def build(self) -> CSRGraph:
        src, dst = kronecker_graph(self.scale, self.edge_factor, self.seed)
        w = uniform_weights(len(src), self.L, self.eps, self.seed)
        return CSRGraph.from_edges(src, dst, w, n=1 << self.scale, symmetrize=False)

    def stream(self):
        """(src, dst, weight) numpy arrays in CSR row-major order."""
        return self.build().to_stream_arrays()


def make_gnn_batch(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    *,
    n_classes: int = 0,
    d_out: int = 0,
    coords: bool = False,
    n_graphs: int = 0,
    seed: int = 0,
    device=None,
) -> GraphBatch:
    """Synthetic GraphBatch with valid masks (connected-ish random graph),
    array for array the reference's for the same arguments."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    ok = src != dst
    if n_classes:
        labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    else:
        labels = rng.normal(size=(n_nodes, max(d_out, 1))).astype(np.float32)
    gid = None
    if n_graphs:
        gid = np.repeat(np.arange(n_graphs), n_nodes // n_graphs).astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    xyz = rng.normal(size=(n_nodes, 3)).astype(np.float32) if coords else None
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return GraphBatch(
        node_feats=t(feats),
        src=t(src.astype(np.int32)),
        dst=t(dst.astype(np.int32)),
        edge_mask=t(ok),
        node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        coords=t(xyz),
        graph_ids=t(gid),
        labels=t(labels),
        label_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
    )


@dataclasses.dataclass
class RecsysPipeline:
    item_vocab: int
    batch: int
    seq_len: int
    n_mask: int
    n_negatives: int
    n_context: int = 16
    seed: int = 0
    device: Any = None

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        dev = resolve_device(self.device)
        zipf = lambda size: (rng.zipf(1.2, size=size) % self.item_vocab).astype(np.int32)
        neg = zipf(self.n_negatives)
        # logQ for zipf(1.2) ~ -1.2 log(rank) - log(zeta); rough correction
        logq = (-1.2 * np.log1p(neg)).astype(np.float32)
        out = {
            "item_ids": zipf((self.batch, self.seq_len)),
            "context_ids": zipf((self.batch, self.n_context)),
            "mask_pos": rng.integers(0, self.seq_len, (self.batch, self.n_mask)).astype(np.int32),
            "labels": zipf((self.batch, self.n_mask)),
            "negatives": neg,
            "neg_logq": logq,
        }
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}
