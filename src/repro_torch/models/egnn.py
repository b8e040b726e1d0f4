"""EGNN — E(n)-equivariant GNN, arXiv:2102.09844 (exact formulation).

m_ij   = phi_e(h_i, h_j, ||x_i - x_j||^2)
x_i'   = x_i + (1/(deg+1)) * sum_j (x_i - x_j) * phi_x(m_ij)
h_i'   = phi_h(h_i, sum_j m_ij)

The distance is squared (no square root). Invariance of h and
equivariance of x under E(n) are exact and tested. n_layers=4,
d_hidden=64 (assigned config). The JAX package's ``repro.models.egnn``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import constrain, zeros
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
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 64
    d_out: int = 1  # per-node scalar target (e.g. energy density)
    edge_chunk: int = 0
    dtype: Any = torch.float32


def param_specs(cfg: EGNNConfig):
    d = cfg.d_hidden
    return {
        "proj": mlp_specs((cfg.d_in, d), cfg.dtype),
        "layers": [
            {
                "phi_e": mlp_specs((2 * d + 1, d, d), cfg.dtype),
                "phi_x": mlp_specs((d, d, 1), cfg.dtype, final_zeros=True),
                "phi_h": mlp_specs((2 * d, d, d), cfg.dtype),
            }
            for _ in range(cfg.n_layers)
        ],
        "head": mlp_specs((d, cfg.d_out), cfg.dtype),
    }


def _layer(lp, h, x, batch: GraphBatch, cfg: EGNNConfig):
    src, dst, emask = batch.src, batch.dst, batch.edge_mask
    E = src.shape[0]
    chunk = cfg.edge_chunk or E
    assert E % chunk == 0
    nc = E // chunk
    m_i = zeros((batch.n, cfg.d_hidden), cfg.dtype, h.device, "nodes", None)
    xv_i = zeros((batch.n, 3), cfg.dtype, h.device, "nodes", None)
    cnt = zeros((batch.n,), cfg.dtype, h.device, "nodes")
    for s, d_, mk in zip(edge_chunks(src, nc), edge_chunks(dst, nc), edge_chunks(emask, nc)):
        rel = take_nodes(x, d_) - take_nodes(x, s)  # [c, 3] (x_i - x_j with i=dst)
        dist2 = (rel * rel).sum(-1, keepdim=True)
        m = mlp_apply(lp.phi_e, torch.cat([take_nodes(h, d_), take_nodes(h, s), dist2], -1))
        m = torch.where(mk[:, None], m, 0)
        w = mlp_apply(lp.phi_x, m)  # [c, 1]
        xv = torch.where(mk[:, None], rel * torch.tanh(w), 0)
        m_i = m_i + segment_sum(m, d_, batch.n)
        xv_i = xv_i + segment_sum(xv, d_, batch.n)
        cnt = cnt + segment_sum(mk.to(cfg.dtype), d_, batch.n)
    x_new = x + xv_i / (cnt[:, None] + 1.0)
    h_new = mlp_apply(lp.phi_h, torch.cat([h, m_i], -1)) + h
    node = batch.node_mask[:, None]
    h_new = constrain(torch.where(node, h_new, 0), "nodes", None)
    x_new = constrain(torch.where(node, x_new, x), "nodes", None)
    return h_new, x_new


class EGNN(nn.Module):
    """EGNN on ``device`` (None: the CUDA card), initialized from ``seed``."""

    def __init__(self, cfg: EGNNConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        build_params(self, param_specs(cfg), resolve_device(device), seed)

    def forward(self, batch: GraphBatch):
        """(node outputs [N, d_out], updated coordinates [N, 3])."""
        cfg = self.cfg
        h = mlp_apply(self.proj, batch.node_feats.to(cfg.dtype))
        h = torch.where(batch.node_mask[:, None], h, 0)
        x = batch.coords.to(cfg.dtype)
        for lp in self.layers:
            h, x = _layer(lp, h, x, batch, cfg)
        return mlp_apply(self.head, h), x

    def loss_fn(self, batch: GraphBatch) -> torch.Tensor:
        out, _ = self(batch)
        return masked_mse(out, batch, self.cfg.d_out)


MODEL = EGNN
