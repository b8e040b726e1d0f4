"""GIN (Graph Isomorphism Network) — arXiv:1810.00826.

h_i' = MLP_k((1 + eps_k) * h_i + sum_{j in N(i)} h_j), learnable eps.
n_layers=5, d_hidden=64, sum aggregator (assigned config). The JAX
package's ``repro.models.gin`` as an ``nn.Module`` whose parameters carry
the reference's tree paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models.gnn_common import (
    GraphBatch,
    chunked_edge_aggregate,
    mlp_apply,
    mlp_specs,
    segment_sum,
    take_nodes,
)
from repro_torch.models.param import ArraySpec, build_params


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 64
    n_classes: int = 40
    readout: str = "none"  # none (node-level) | sum (graph-level)
    edge_chunk: int = 0
    dtype: Any = torch.float32


def param_specs(cfg: GINConfig):
    return {
        "proj": mlp_specs((cfg.d_in, cfg.d_hidden), cfg.dtype),
        "eps": ArraySpec((cfg.n_layers,), (None,), cfg.dtype, "zeros"),
        "layers": [
            mlp_specs((cfg.d_hidden, cfg.d_hidden, cfg.d_hidden), cfg.dtype)
            for _ in range(cfg.n_layers)
        ],
        "head": mlp_specs((cfg.d_hidden, cfg.n_classes), cfg.dtype),
    }


class GIN(nn.Module):
    """GIN on ``device`` (None: the CUDA card), initialized from ``seed``."""

    def __init__(self, cfg: GINConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        build_params(self, param_specs(cfg), resolve_device(device), seed)

    def _embed(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        node = batch.node_mask[:, None]
        h = mlp_apply(self.proj, batch.node_feats.to(cfg.dtype))
        h = torch.where(node, h, 0)
        for k in range(cfg.n_layers):
            agg = chunked_edge_aggregate(
                lambda s, d, m: take_nodes(h, s),
                batch.src, batch.dst, batch.edge_mask, batch.n,
                cfg.d_hidden, cfg.edge_chunk, cfg.dtype,
            )
            h = mlp_apply(self.layers[k], (1.0 + self.eps[k]) * h + agg, layernorm=True)
            h = constrain(torch.where(node, h, 0), "nodes", None)
        return h

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """Node logits [N, n_classes]."""
        return mlp_apply(self.head, self._embed(batch))

    def graph_logits(self, batch: GraphBatch, n_graphs: int) -> torch.Tensor:
        """Graph logits [n_graphs, n_classes]: the node states summed over
        ``graph_ids``, then the head."""
        pooled = segment_sum(self._embed(batch), batch.graph_ids, n_graphs)
        return mlp_apply(self.head, pooled)

    def loss_fn(self, batch: GraphBatch) -> torch.Tensor:
        """Mean cross-entropy over the labelled nodes (logsumexp minus the
        gold logit), divided by max(#labelled, 1)."""
        logits = self(batch).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch.labels.long()[:, None])[:, 0]
        nll = torch.where(batch.label_mask, lse - gold, 0.0)
        return nll.sum() / torch.clamp(batch.label_mask.sum(), min=1)


MODEL = GIN
