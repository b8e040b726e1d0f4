"""Segment-op message passing, the GNN primitive: gather -> transform ->
segment-reduce, as ``index_add_`` and ``scatter_reduce_`` on the data's
device (the JAX package's ``jax.ops.segment_*``).

Sums on the card accumulate with atomics, in an order that changes from
run to run: they agree with the CPU to rounding, not bit for bit. An empty
segment's maximum is what ``jax.ops.segment_max`` gives: ``-inf`` for
floating types, the type's least value for integers.
"""
from __future__ import annotations

import torch


def _lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _rows(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """int64 segment ids broadcast (as a view) to ``data``'s shape."""
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1))
    return ids.expand_as(data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), _lowest(data.dtype))
    return out.scatter_reduce_(0, _rows(segment_ids, data), data, "amax", include_self=False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    s = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    cnt = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(cnt, min=1.0)[(...,) + (None,) * (data.ndim - 1)]


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Edge-softmax (GAT-style): softmax of ``scores`` within each segment."""
    ids = segment_ids.long()
    mx = segment_max(scores, ids, num_segments)
    ex = torch.exp(scores - mx[ids])
    z = segment_sum(ex, ids, num_segments)
    return ex / torch.clamp(z[ids], min=1e-9)


def scatter_messages(node_feats, src, dst, num_nodes: int, reduce: str = "sum"):
    """h'_v = reduce_{(u,v) in E} h_u: plain message passing."""
    msgs = node_feats[src.long()]
    if reduce == "sum":
        return segment_sum(msgs, dst, num_nodes)
    if reduce == "mean":
        return segment_mean(msgs, dst, num_nodes)
    if reduce == "max":
        return segment_max(msgs, dst, num_nodes)
    raise ValueError(reduce)


def degrees(src, dst, num_nodes: int):
    ones = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    return segment_sum(ones, src, num_nodes) + segment_sum(ones, dst, num_nodes)
