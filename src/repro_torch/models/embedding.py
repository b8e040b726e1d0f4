"""EmbeddingBag: gather + segment-reduce, the JAX package's
``repro.models.embedding``.

table [V, D]; bags are (ids [B, bag], weights?) -> pooled [B, D]. Rows are
read as ``jnp.take`` reads them (:func:`take_rows`): a negative id counts
from the end, an id outside [-V, V) reads NaN; ``valid`` masks padding ids
after the gather, as the reference's ``where`` does. The rows are read
through ``F.embedding``, whose backward sums the rows of one id in sorted
segments: indexing's backward (``index_put_`` with ``accumulate``) walks
an id's duplicates one after another, and zipf-skewed ids made it half of
a BERT4Rec train step (PERF.md §6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.graph.segment import segment_max, segment_mean, segment_sum


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows [*ids.shape, D]; -1 is the last
    row, an id outside [-V, V) a row of NaN (``index_select`` would raise)
    that takes no gradient."""
    V = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    outside = (idx < 0) | (idx >= V)
    return F.embedding(idx.clamp(0, V - 1), table).masked_fill(outside[..., None], float("nan"))


def embedding_bag(table, ids, mode: str = "sum", weights=None, valid=None):
    """table [V, D]; ids int [B, bag]; valid bool [B, bag] masks padding."""
    B, bag = ids.shape
    emb = take_rows(table, ids.reshape(-1)).reshape(B, bag, -1)
    if weights is not None:
        emb = emb * weights[..., None].to(emb.dtype)
    if valid is not None:
        emb = torch.where(valid[..., None], emb, 0)
    if mode == "sum":
        return emb.sum(dim=1)
    if mode == "mean":
        denom = (
            valid.sum(dim=1, keepdim=True).to(emb.dtype)
            if valid is not None
            else torch.full((B, 1), bag, dtype=emb.dtype, device=emb.device)
        )
        return emb.sum(dim=1) / torch.clamp(denom, min=1)
    if mode == "max":
        if valid is not None:
            emb = torch.where(valid[..., None], emb, torch.finfo(emb.dtype).min)
        return emb.amax(dim=1)
    raise ValueError(mode)


def embedding_bag_ragged(table, flat_ids, segment_ids, num_bags: int, mode: str = "sum"):
    """Ragged variant: flat_ids [T], segment_ids [T] -> [num_bags, D]."""
    emb = take_rows(table, flat_ids)
    if mode == "sum":
        return segment_sum(emb, segment_ids, num_bags)
    if mode == "mean":
        return segment_mean(emb, segment_ids, num_bags)
    if mode == "max":
        return segment_max(emb, segment_ids, num_bags)
    raise ValueError(mode)
