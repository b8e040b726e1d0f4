"""MeshGraphNet — arXiv:2010.03409. Encode-Process-Decode.

Encoder: node/edge MLPs into latent d=128.
Processor (15 steps): e' = e + MLP([e, h_src, h_dst]); h' = h + MLP([h, sum e']),
the edge state updated chunk by chunk.
Decoder: node MLP -> output (acceleration).
All MLPs: 2 hidden layers + LayerNorm (paper setup). Assigned: n_layers=15,
d_hidden=128, sum aggregator, mlp_layers=2. The JAX package's
``repro.models.meshgraphnet``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import cat_rows, constrain, zeros
from repro_torch.models.gnn_common import (
    GraphBatch,
    edge_chunks,
    masked_mse,
    mlp_apply,
    mlp_specs,
    segment_sum,
    take_nodes,
)
from repro_torch.models.param import build_params


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    d_in: int = 16
    d_edge_in: int = 4  # rel coords (3) + norm (1)
    d_out: int = 3
    edge_chunk: int = 0
    dtype: Any = torch.float32


def param_specs(cfg: MGNConfig):
    d = cfg.d_hidden
    return {
        "enc_node": mlp_specs((cfg.d_in, d, d, d), cfg.dtype),
        "enc_edge": mlp_specs((cfg.d_edge_in, d, d, d), cfg.dtype),
        "layers": [
            {
                "edge_mlp": mlp_specs((3 * d, d, d, d), cfg.dtype),
                "node_mlp": mlp_specs((2 * d, d, d, d), cfg.dtype),
            }
            for _ in range(cfg.n_layers)
        ],
        "dec": mlp_specs((d, d, d, cfg.d_out), cfg.dtype),
    }


def _edge_feats(batch: GraphBatch, cfg: MGNConfig):
    """The batch's edge features, else (x_dst - x_src, its norm). The norm
    depends on coordinates only, so its gradient at a self-loop (rel = 0)
    never reaches a parameter."""
    if batch.edge_feats is not None:
        return batch.edge_feats.to(cfg.dtype)
    rel = take_nodes(batch.coords, batch.dst) - take_nodes(batch.coords, batch.src)
    norm = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    return torch.cat([rel, norm], -1).to(cfg.dtype)


class MeshGraphNet(nn.Module):
    """MeshGraphNet on ``device`` (None: the CUDA card), initialized from ``seed``."""

    def __init__(self, cfg: MGNConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        build_params(self, param_specs(cfg), resolve_device(device), seed)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        h = mlp_apply(self.enc_node, batch.node_feats.to(cfg.dtype), layernorm=True)
        e = mlp_apply(self.enc_edge, _edge_feats(batch, cfg), layernorm=True)
        node = batch.node_mask[:, None]
        h = torch.where(node, h, 0)
        e = torch.where(batch.edge_mask[:, None], e, 0)
        E = batch.e
        chunk = cfg.edge_chunk or E
        assert E % chunk == 0
        nc = E // chunk
        chunks = list(zip(edge_chunks(batch.src, nc), edge_chunks(batch.dst, nc),
                          edge_chunks(batch.edge_mask, nc)))
        for lp in self.layers:
            agg = zeros((batch.n, cfg.d_hidden), cfg.dtype, h.device, "nodes", None)
            e_parts = []
            for (s, d_, mk), ec in zip(chunks, edge_chunks(e, nc)):
                inp = torch.cat([ec, take_nodes(h, s), take_nodes(h, d_)], -1)
                e_new = ec + mlp_apply(lp.edge_mlp, inp, layernorm=True)
                e_new = torch.where(mk[:, None], e_new, 0)
                agg = agg + segment_sum(e_new, d_, batch.n)
                e_parts.append(e_new)
            e = cat_rows(e_parts, e)
            h = h + mlp_apply(lp.node_mlp, torch.cat([h, agg], -1), layernorm=True)
            h = constrain(torch.where(node, h, 0), "nodes", None)
        return mlp_apply(self.dec, h)

    def loss_fn(self, batch: GraphBatch) -> torch.Tensor:
        return masked_mse(self(batch), batch, self.cfg.d_out)


MODEL = MeshGraphNet
