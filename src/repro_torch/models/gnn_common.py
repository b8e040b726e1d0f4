"""Shared GNN machinery: flat GraphBatch + MLP + chunked message passing.

All four GNN shapes reduce to one flat representation:
  * full-batch graphs: one graph, masks all-true;
  * sampled minibatch (fanout 15-10): the sampler's merged subgraph;
  * batched small molecules: disjoint union, ``graph_ids`` for readout.

Message passing is gather -> transform -> segment sum, the segment sum an
out-of-place ``index_add`` (autograd holds; on the card it accumulates with
atomics, so float32 sums come out in an order that changes from run to
run), with optional edge chunking (a Python loop) so multi-10M-edge graphs
never hold [E, d] at once. The JAX package's ``repro.models.gnn_common``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import on_mesh, row_chunks as edge_chunks, row_layout, zeros
from repro_torch.models.param import ArraySpec


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    node_feats: torch.Tensor  # [N, F] float
    src: torch.Tensor  # [E] int32
    dst: torch.Tensor  # [E] int32
    edge_mask: torch.Tensor  # [E] bool
    node_mask: torch.Tensor  # [N] bool
    coords: Optional[torch.Tensor] = None  # [N, 3]
    edge_feats: Optional[torch.Tensor] = None  # [E, Fe]
    graph_ids: Optional[torch.Tensor] = None  # [N] int32 (batched readout)
    labels: Optional[torch.Tensor] = None  # [N] int32 or [N, d_out] float
    label_mask: Optional[torch.Tensor] = None  # [N] bool

    @property
    def n(self) -> int:
        return self.node_feats.shape[0]

    @property
    def e(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "GraphBatch":
        """The batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if getattr(self, f.name) is not None
        })


def mlp_specs(name_dims, dtype=torch.float32, final_zeros: bool = False):
    """[(d0, d1, d2, ...)] -> {wi, bi} specs, weights [d_in, d_out] as in the
    reference (not ``nn.Linear``'s transposed layout)."""
    specs = {}
    dims = name_dims
    for i in range(len(dims) - 1):
        init = "zeros" if (final_zeros and i == len(dims) - 2) else "normal"
        specs[f"w{i}"] = ArraySpec((dims[i], dims[i + 1]), (None, None), dtype, init)
        specs[f"b{i}"] = ArraySpec((dims[i + 1],), (None,), dtype, "zeros")
    return specs


def mlp_apply(params, x, act=F.silu, layernorm: bool = False, eps=1e-5):
    """``x @ w0 + b0``, ``act``, ... (no act after the last layer), then a
    layernorm without parameters. ``params``: a module holding ``w{i}`` /
    ``b{i}`` (:func:`mlp_specs`), or a dict of them."""
    p = dict(params) if isinstance(params, dict) else dict(params.named_parameters(recurse=False))
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = act(x)
    if layernorm:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
    return x


class _SegmentSum(torch.autograd.Function):
    """``index_add`` into zeros whose backward saves only the ids: autograd's
    own ``index_add`` saves its source for the backward (for its shape), an
    [E, d] message tensor a layer (15.8 GB at ogb_products, d = 64)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
        return out.index_add_(0, ids, data)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: an ``index_add`` into zeros (out of place
    for autograd; the gradient of ``data`` is ``grad[ids]``). On DTensors
    whose rows (edges) are split over some mesh dimensions, each rank sums
    its own rows into a whole [num_segments, ...] block: the result is a
    partial sum over those dimensions (the caller's layout reduces it)."""
    if not isinstance(ids, DTensor):
        return _SegmentSum.apply(data, ids, num_segments)
    place = row_layout(ids)
    out = [Partial() if p.is_shard() else Replicate() for p in place]
    return local_map(lambda dl, il: _SegmentSum.apply(dl, il, num_segments), out_placements=out,
                     in_placements=(place, place), device_mesh=ids.device_mesh)(data, ids)


def take_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, idx)``: the rows of the node tensor ``x`` at the
    edges' node ids ``idx``. On a DTensor ``idx`` (edges split over some mesh
    dimensions) ``x`` is gathered whole and each rank reads its edges' rows;
    the gradient of ``x`` is a partial sum over those dimensions."""
    if not isinstance(idx, DTensor):
        return x.index_select(0, idx)
    mesh, place = idx.device_mesh, row_layout(idx)
    whole = [Replicate()] * mesh.ndim
    x = on_mesh(x, mesh).redistribute(mesh, whole)
    grad = [Partial() if p.is_shard() else Replicate() for p in place]
    return local_map(lambda xl, il: xl.index_select(0, il), out_placements=place,
                     in_placements=(whole, place), in_grad_placements=(grad, place),
                     device_mesh=mesh)(x, idx)


def masked_mse(out, batch: GraphBatch, d_out: int) -> torch.Tensor:
    """Squared error over the labelled nodes, divided by max(#labelled *
    d_out, 1): the loss of EGNN, MeshGraphNet and Equiformer-v2."""
    err = (out.float() - batch.labels.float()) ** 2
    mask = batch.label_mask[:, None]
    return torch.where(mask, err, 0).sum() / torch.clamp(mask.sum() * d_out, min=1)


def chunked_edge_aggregate(msg_fn, src, dst, edge_mask, n_nodes: int,
                           out_dim: int, edge_chunk: int = 0, dtype=torch.float32):
    """sum_{e: dst(e)=v} msg_fn(e_indices) with optional chunking.

    msg_fn(src_idx, dst_idx, mask) -> [chunk, out_dim] messages, a fresh
    tensor: masked edges are zeroed in place (``masked_fill_``, saving one
    [E, d] copy; autograd raises if a message was saved for backward).
    """
    E = src.shape[0]
    if not edge_chunk or E <= edge_chunk:
        m = msg_fn(src, dst, edge_mask).masked_fill_(~edge_mask[:, None], 0)
        return segment_sum(m, dst, n_nodes)
    assert E % edge_chunk == 0, (E, edge_chunk)
    nc = E // edge_chunk
    acc = zeros((n_nodes, out_dim), dtype, src.device, "nodes", None)
    for s, d, mk in zip(edge_chunks(src, nc), edge_chunks(dst, nc), edge_chunks(edge_mask, nc)):
        m = msg_fn(s, d, mk).masked_fill_(~mk[:, None], 0)
        acc = acc + segment_sum(m, d, n_nodes)
    return acc
