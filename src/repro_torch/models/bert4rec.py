"""BERT4Rec — arXiv:1904.06690. Bidirectional transformer over item
sequences with masked-item (cloze) training; the JAX package's
``repro.models.bert4rec``.

Assigned: embed_dim=64, n_blocks=2, n_heads=2, seq_len=200, bidirectional.
:class:`Bert4Rec` holds the reference's parameter tree (the blocks a list
of dicts: ``layers.0.wqkv``), so its ``state_dict`` keys are the
reference's leaves. Serving scores the last position's representation
against the full item table (:func:`serve_scores`) or a candidate set
(:func:`score_candidates`); a context EmbeddingBag (``models/embedding.py``)
pools multi-hot user-context ids into the sequence. Training
(:func:`loss_fn`) is the cloze loss under a sampled softmax over shared
negatives with the logQ correction: no [B, S, V] logits. Rows are read as
``jnp.take`` reads them (an id outside the table reads NaN, and its
gradient is dropped). The reference's ``jax.nn.gelu`` is the tanh
approximation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models.embedding import embedding_bag, take_rows
from repro_torch.models.param import ArraySpec, build_params


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    item_vocab: int = 1_000_000
    n_context: int = 16  # context bag size (EmbeddingBag path)
    n_mask: int = 40  # masked positions per sequence (20 %)
    n_negatives: int = 8192  # sampled-softmax shared negatives
    norm_eps: float = 1e-6
    dtype: Any = torch.float32


def param_specs(cfg: Bert4RecConfig):
    d = cfg.embed_dim
    layers = []
    for _ in range(cfg.n_blocks):
        layers.append(
            {
                "wqkv": ArraySpec((d, 3 * d), ("embed", "heads"), cfg.dtype),
                "wo": ArraySpec((d, d), ("heads", "embed"), cfg.dtype),
                "ln1": ArraySpec((d,), (None,), cfg.dtype, "ones"),
                "ln2": ArraySpec((d,), (None,), cfg.dtype, "ones"),
                "w1": ArraySpec((d, 4 * d), ("embed", "mlp"), cfg.dtype),
                "b1": ArraySpec((4 * d,), ("mlp",), cfg.dtype, "zeros"),
                "w2": ArraySpec((4 * d, d), ("mlp", "embed"), cfg.dtype),
                "b2": ArraySpec((d,), (None,), cfg.dtype, "zeros"),
            }
        )
    return {
        "items": ArraySpec((cfg.item_vocab, d), ("rows", "embed"), cfg.dtype, "embed", 0.02),
        "pos": ArraySpec((cfg.seq_len, d), ("seq", "embed"), cfg.dtype, "embed", 0.02),
        "context": ArraySpec((cfg.item_vocab, d), ("rows", "embed"), cfg.dtype, "embed", 0.02),
        "layers": layers,
        "ln_f": ArraySpec((d,), (None,), cfg.dtype, "ones"),
    }


class Bert4Rec(nn.Module):
    """BERT4Rec's parameters on ``device`` (None: the CUDA card), drawn from
    ``seed`` on the CPU, or from ``generator`` (a seeded
    ``torch.Generator("cuda")`` draws on the card)."""

    def __init__(self, cfg: Bert4RecConfig, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        build_params(self, param_specs(cfg), resolve_device(device), seed, generator)


def _ln(x, scale, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


def encode(model: Bert4Rec, item_ids, context_ids):
    """item_ids [B, S]; context_ids [B, n_context] -> hidden [B, S, d].
    Autograd records it unless the caller turns it off, as serving does."""
    cfg = model.cfg
    B, S = item_ids.shape
    d, H = cfg.embed_dim, cfg.n_heads
    x = take_rows(model.items, item_ids) + model.pos[None, :S]
    ctx = embedding_bag(model.context, context_ids, mode="mean", valid=context_ids >= 0)
    x = x + ctx[:, None, :]
    for lp in model.layers:
        h = _ln(x, lp.ln1, cfg.norm_eps)
        qkv = (h @ lp.wqkv).reshape(B, S, 3, H, d // H)
        q, k, v = (qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3))  # [B, H, S, dh]
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        s = s / np.sqrt(d // H)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        attn = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(B, S, d)
        x = x + attn @ lp.wo
        h2 = _ln(x, lp.ln2, cfg.norm_eps)
        x = x + F.gelu(h2 @ lp.w1 + lp.b1, approximate="tanh") @ lp.w2 + lp.b2
    return _ln(x, model.ln_f, cfg.norm_eps)


def take_along_positions(h, pos):
    """``jnp.take_along_axis(h, pos[..., None], axis=1)``: h [B, S, d], pos
    int [B, m] -> [B, m, d]; a negative position counts from the end, one
    outside [-S, S) reads NaN."""
    S = h.shape[1]
    idx = pos.long()
    idx = torch.where(idx < 0, idx + S, idx)
    outside = (idx < 0) | (idx >= S)
    rows = torch.gather(h, 1, idx.clamp(0, S - 1)[..., None].expand(-1, -1, h.shape[-1]))
    return rows.masked_fill(outside[..., None], float("nan"))


def loss_fn(model: Bert4Rec, batch: dict):
    """Cloze loss with sampled softmax (the reference's ``loss_fn``).

    batch: item_ids [B, S], context_ids [B, nc], mask_pos [B, n_mask],
    labels [B, n_mask], negatives [n_neg] (shared), neg_logq [n_neg] float32
    (the log sampling probability, subtracted from the negatives' logits).
    The mean over masked positions of ``logsumexp([pos, neg - logq]) -
    pos``."""
    h = encode(model, batch["item_ids"], batch["context_ids"])
    hm = take_along_positions(h, batch["mask_pos"])  # [B, n_mask, d]
    pos_emb = take_rows(model.items, batch["labels"])  # [B, n_mask, d]
    neg_emb = take_rows(model.items, batch["negatives"])  # [n_neg, d]
    pos_logit = (hm * pos_emb).sum(-1, keepdim=True).float()
    neg_logit = torch.matmul(hm, neg_emb.T).float() - batch["neg_logq"][None, None, :]
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    # logits[..., 0] is pos_logit: its gradient needs no [B, n_mask, 1 + n_neg] zeros
    return (torch.logsumexp(logits, -1) - pos_logit[..., 0]).mean()


@torch.no_grad()
def score_candidates(model: Bert4Rec, item_ids, context_ids, candidates):
    """Retrieval scoring: last-position user repr vs candidate item rows.

    candidates int [n_cand] -> float32 scores [B, n_cand].
    """
    h = constrain(encode(model, item_ids, context_ids)[:, -1], "dp", None)  # [B, d]
    # rows of a row-split table are partial sums: reduced onto the candidates' split
    cand = constrain(take_rows(model.items, candidates), "rows", None)  # [n_cand, d]
    return h.float() @ cand.float().T


@torch.no_grad()
def serve_scores(model: Bert4Rec, item_ids, context_ids):
    """Online/bulk serving: float32 scores [B, V] against the *full* item table."""
    h = encode(model, item_ids, context_ids)[:, -1]
    return h.float() @ model.items.float().T
