"""(arch x shape) -> step functions: the JAX package's ``repro.launch.steps``
for the GNN, LM and recsys train steps and the LM and recsys serving steps.

* GNNs: the shape's config (:func:`gnn_shape_config`), the padded batch
  dimensions (:func:`gnn_batch_dims`), the spec trees of one step's inputs
  and state, the model, and a train step (:func:`make_gnn_train_step`);
* LMs: the shape's config (:func:`lm_shape_config`), the input and state
  specs, the train step (:func:`make_lm_train_step`) and the prefill and
  decode steps (:func:`make_lm_prefill`, :func:`make_lm_decode`);
* BERT4Rec: the input and state specs, the two-stage top-k
  (:func:`sharded_topk`, also over a DTensor score block sharded over the
  vocabulary: each rank's columns first, then the shards' candidates) and
  the train, serving and retrieval steps
  (:func:`make_recsys_step`);
* :func:`default_opt_cfg`: bf16 moments above 100 B parameters.

* :func:`arch_rules`: the logical-axis -> mesh-axis map of the production
  meshes, and :func:`build_step`: an (arch, shape) step with its argument
  templates (``meta`` tensors) and placements, as the dry-run takes it.

Each step runs on the ``device`` it was made for (None: the CUDA card;
``"meta"`` for the dry-run) and moves its batch there.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.registry import ArchSpec, ShapeSpec, sampled_subgraph_sizes
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import cat_rows, resolve, row_chunks, sharding_rules
from repro_torch.models import bert4rec as b4r
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn_common import GraphBatch
from repro_torch.models.param import ArraySpec, PSpec, abstract_params, pspecs
from repro_torch.optim import AdamW, AdamWConfig, adamw_init_specs

N_SRC_BLOCKS = 16  # paper-style blocking: one node block resident/chunk


def _gnn_module(arch: ArchSpec):
    return importlib.import_module(f"repro_torch.models.{arch.gnn_model}")


def _rup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# --------------------------------------------------------------- rules


def arch_rules(arch: ArchSpec, shape: ShapeSpec, multi_pod: bool) -> dict:
    """The logical-axis -> mesh-axis map of the production meshes (the
    reference's, key for key): ``("data", "model")`` 16x16, or ``("pod",
    "data", "model")`` 2x16x16 with ``multi_pod``."""
    dp = ("pod", "data") if multi_pod else ("data",)
    model = "model"
    msize = 16
    rules: dict[str, Any] = {
        "dp": dp,
        "layers": None,
        "vocab": model,
        "mlp": model,
        "rows": model,
        "seq": None,
        "nodes": None,
        "edges": dp,
        "cache_batch": dp,
    }
    if arch.family == "lm":
        cfg: tfm.TransformerConfig = arch.config
        rules["embed"] = "data"  # FSDP: d_model rows over data
        # minicpm's 36 heads do not divide the model axis: they stay replicated
        rules["heads"] = model if cfg.n_heads % msize == 0 else None
        rules["kv_heads"] = model if cfg.n_kv % msize == 0 else None
        # heads-sharded archs shard the layer boundary's feature dimension;
        # replicated-head archs shard the sequence (their sequence-parallel
        # attention)
        sharded_heads = cfg.n_heads % msize == 0
        rules["model_seq"] = None if sharded_heads else model
        rules["model_d"] = model if sharded_heads else None
        rules["expert"] = model if cfg.expert_sharding == "ep" else None
        rules["expert_mlp"] = model if cfg.expert_sharding == "tp" else None
        if shape.kind in ("decode", "prefill"):
            if shape.kind == "decode" and shape.global_batch == 1:
                rules["cache_batch"] = None
                rules["seq"] = dp + (model,) if rules["kv_heads"] is None else dp
            elif rules["kv_heads"] is None:
                rules["seq"] = model
    elif arch.family == "gnn":
        big = shape.n_nodes > 100_000
        if shape.n_nodes > 1_000_000:  # split the node state over both axes
            # but GIN's, whose message is its source's state alone: it stays
            # replicated (2.4M x 64 float32, 627 MB), the edges data-parallel
            # with an all-reduce per layer
            rules["nodes"] = None if arch.gnn_model == "gin" else ("data", model)
        else:
            rules["nodes"] = model if big else None
        rules["edges"] = dp + (model,) if big else dp
        rules["embed"] = None
    else:  # recsys
        rules["embed"] = None
        rules["heads"] = None
        rules["seq"] = None
        if shape.batch and shape.batch < 16:  # retrieval: a single query
            rules["dp"] = None
    return rules


def gnn_edge_chunk(arch: ArchSpec, shape: ShapeSpec) -> int:
    # only the irrep-heavy model needs chunked message passing on the
    # large graph; equiformer x products runs src-blocked: chunk = E / 16.
    if arch.id == "equiformer-v2" and shape.name == "ogb_products":
        e_pad = _rup(shape.n_edges, N_SRC_BLOCKS * 4096)
        return e_pad // N_SRC_BLOCKS
    return 0


def gnn_shape_config(arch: ArchSpec, shape: ShapeSpec):
    """The arch's config at the shape. The reference's ``unroll`` switch (a
    dry-run's unrolled chunk loop) has no counterpart: the port's chunk
    loops are Python loops."""
    cfg = arch.config
    over = dict(edge_chunk=gnn_edge_chunk(arch, shape))
    if arch.id == "equiformer-v2" and shape.name == "ogb_products":
        over["src_blocked"] = True
    if shape.name == "molecule":
        over["d_in"] = 16
    else:
        over["d_in"] = shape.d_feat
    if arch.id == "gin-tu" and shape.n_classes:
        over["n_classes"] = shape.n_classes
    return dataclasses.replace(cfg, **over)


def gnn_batch_dims(shape: ShapeSpec, chunk: int = 0):
    """(N_pad, E_pad) static sizes for the GraphBatch."""
    if shape.name == "minibatch_lg":
        n, e = sampled_subgraph_sizes(shape)
    elif shape.name == "molecule":
        n = shape.n_nodes * shape.batch_graphs
        e = shape.n_edges * shape.batch_graphs
    else:
        n, e = shape.n_nodes, shape.n_edges
    n = _rup(n, 256)
    e = _rup(e, chunk if chunk else 256)
    if chunk:
        e = _rup(e, chunk)
    return n, e


def gnn_input_specs(arch: ArchSpec, shape: ShapeSpec):
    cfg = gnn_shape_config(arch, shape)
    N, E = gnn_batch_dims(shape, cfg.edge_chunk)
    label_like = (
        ArraySpec((N,), ("nodes",), torch.int32, "zeros")
        if arch.id == "gin-tu"
        else ArraySpec((N, cfg.d_out), ("nodes", None), torch.float32, "zeros")
    )
    specs = {
        "node_feats": ArraySpec((N, cfg.d_in), ("nodes", None), torch.float32),
        "src": ArraySpec((E,), ("edges",), torch.int32, "zeros"),
        "dst": ArraySpec((E,), ("edges",), torch.int32, "zeros"),
        "edge_mask": ArraySpec((E,), ("edges",), torch.bool, "zeros"),
        "node_mask": ArraySpec((N,), ("nodes",), torch.bool, "zeros"),
        "labels": label_like,
        "label_mask": ArraySpec((N,), ("nodes",), torch.bool, "zeros"),
    }
    if arch.id in ("egnn", "equiformer-v2", "meshgraphnet"):
        specs["coords"] = ArraySpec((N, 3), ("nodes", None), torch.float32)
    return specs


def gnn_state_specs(arch: ArchSpec, shape: ShapeSpec, opt_cfg: AdamWConfig):
    cfg = gnn_shape_config(arch, shape)
    pspec_tree = _gnn_module(arch).param_specs(cfg)
    return pspec_tree, adamw_init_specs(pspec_tree, opt_cfg)


def make_gnn_model(arch: ArchSpec, shape: ShapeSpec, device=None, seed: int = 0):
    """The arch's model at the shape's config, on ``device`` (None: the card)."""
    return _gnn_module(arch).MODEL(gnn_shape_config(arch, shape), device=device, seed=seed)


def _descend(opt: AdamW, loss, lr) -> dict:
    """``loss``'s gradients (fresh) and one :class:`AdamW` step at ``lr``
    (None: the optimizer's); ``{"loss", "grad_norm"}`` (the norm before
    clipping)."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if isinstance(loss, DTensor):  # a sharded step's loss: its global value
        loss = loss.full_tensor()
    return {"loss": loss.detach(), "grad_norm": opt.step(lr=lr)}


def train_step(model, opt: AdamW, batch: GraphBatch, lr: float | None = None) -> dict:
    """One step on the batch's device: the loss, its gradients, one
    :class:`AdamW` step (at ``lr``, else the optimizer's); ``{"loss",
    "grad_norm"}`` (the norm before clipping). Updates in place."""
    return _descend(opt, model.loss_fn(batch), lr)


def make_gnn_train_step(arch: ArchSpec, shape: ShapeSpec, opt_cfg: AdamWConfig, device=None):
    """``step(model, opt, batch) -> {"loss", "grad_norm"}``: :func:`train_step`
    at ``opt_cfg.lr`` on ``device`` (None: the card), the batch (a dict of
    :func:`gnn_input_specs`'s keys or a :class:`GraphBatch`) moved there.
    The model and the optimizer are updated in place."""
    dev = resolve_device(device)

    def step(model, opt: AdamW, batch):
        if isinstance(batch, dict):
            batch = GraphBatch(
                node_feats=batch["node_feats"],
                src=batch["src"],
                dst=batch["dst"],
                edge_mask=batch["edge_mask"],
                node_mask=batch["node_mask"],
                coords=batch.get("coords"),
                labels=batch["labels"],
                label_mask=batch["label_mask"],
            )
        return train_step(model, opt, batch.to(dev), opt_cfg.lr)

    return step


# --------------------------------------------------------------- LM


def lm_shape_config(arch: ArchSpec, shape: ShapeSpec, multi_pod: bool = False
                    ) -> tfm.TransformerConfig:
    """The arch's config at the shape: the reference's ``_lm_shape_overrides``
    (its ``unroll`` switch changes nothing in the port: the loops are Python
    loops). ``multi_pod``: the MoE dispatch groups are the 32 data-parallel
    shards of two pods, not 16."""
    cfg: tfm.TransformerConfig = arch.config
    # replicated-head archs (36 % 16 != 0) run sequence-parallel attention:
    # `attn_par` query chunks batched into one product
    sharded_heads = cfg.n_heads % 16 == 0
    par = 1 if sharded_heads else 16
    # MoE dispatch groups = DP degree (per-shard-local dispatch); decode
    # batches may be smaller than DP
    dp_size = 32 if multi_pod else 16
    groups = min(dp_size, shape.global_batch) if cfg.is_moe else 1
    if shape.kind == "train":
        return dataclasses.replace(
            cfg, attn_chunk=512 if sharded_heads else 256, attn_par=par,
            loss_chunk=256, unroll=False, moe_groups=groups,
        )
    if shape.kind == "prefill":
        return dataclasses.replace(
            cfg, attn_chunk=2048 if sharded_heads else 256, attn_par=par,
            loss_chunk=512, remat=True, unroll=False, moe_groups=groups,
        )
    return dataclasses.replace(cfg, unroll=False, moe_groups=groups)


def lm_state_specs(arch: ArchSpec, opt_cfg: AdamWConfig):
    """(parameter spec tree, AdamW state spec tree) at the arch's config."""
    pspec_tree = tfm.param_specs(arch.config)
    return pspec_tree, adamw_init_specs(pspec_tree, opt_cfg)


def lm_input_specs(arch: ArchSpec, shape: ShapeSpec):
    cfg: tfm.TransformerConfig = arch.config
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return {"tokens": ArraySpec((B, S), ("dp", None), torch.int32, "zeros")}
    if shape.kind == "decode":
        cache = {
            name: ArraySpec(s.shape, ("layers", "cache_batch", "seq", "kv_heads", None),
                            s.dtype, "zeros")
            for name, s in tfm.kv_cache_specs(cfg, B, S).items()
        }
        return {
            "cache": cache,
            "token": ArraySpec((B,), ("cache_batch",), torch.int32, "zeros"),
        }
    raise ValueError(shape.kind)


def make_lm_train_step(arch: ArchSpec, shape: ShapeSpec, opt_cfg: AdamWConfig, device=None,
                       multi_pod: bool = False):
    """``step(model, opt, batch, lr=None) -> {"loss", "grad_norm"}``: the
    next-token loss of ``batch["tokens"]`` (:func:`tfm.loss_fn` at the
    shape's config: layers, attention steps and loss chunks checkpointed),
    its gradients and one :class:`AdamW` step at ``lr`` (default
    ``opt_cfg.lr``, as the reference's step; a trainer passes its
    schedule's), on ``device`` (None: the card). The model and the
    optimizer are updated in place."""
    cfg = lm_shape_config(arch, shape, multi_pod)
    dev = resolve_device(device)

    def step(model: tfm.Transformer, opt: AdamW, batch, lr: float | None = None):
        loss = tfm.loss_fn(model, batch["tokens"].to(dev), cfg)
        return _descend(opt, loss, opt_cfg.lr if lr is None else lr)

    return step


def make_lm_prefill(arch: ArchSpec, shape: ShapeSpec, device=None, max_len=None,
                    multi_pod: bool = False):
    """``step(model, batch) -> (cache, logits [B, V])``: the prompt
    ``batch["tokens"]`` through :func:`tfm.prefill` at the shape's config on
    ``device`` (None: the card), into a cache of ``max_len`` slots (default
    the prompt's length, the reference's cache), and the last position's
    float32 logits (no soft cap, as the reference's step)."""
    cfg = lm_shape_config(arch, shape, multi_pod)
    dev = resolve_device(device)

    @torch.no_grad()
    def step(model: tfm.Transformer, batch):
        cache, last_h = tfm.prefill(model, batch["tokens"].to(dev), cfg, max_len)
        return cache, tfm.lm_logits(model, last_h, cfg, softcap=False)

    return step


def make_lm_decode(arch: ArchSpec, shape: ShapeSpec, device=None, multi_pod: bool = False):
    """``step(model, batch) -> (logits [B, V], cache)``: one
    :func:`tfm.decode_step` of ``batch["token"]`` against ``batch["cache"]``
    at ``cache_len = S - 1`` (S the shape's length), on ``device`` (None:
    the card); the new k/v are committed in place at slot S - 1 and the
    same cache returned (the reference's ``dynamic_update_slice`` on a
    donated buffer)."""
    cfg = lm_shape_config(arch, shape, multi_pod)
    dev = resolve_device(device)
    S = shape.seq_len

    @torch.no_grad()
    def step(model: tfm.Transformer, batch):
        cache = batch["cache"]
        logits, (knew, vnew) = tfm.decode_step(model, cache, batch["token"].to(dev), S - 1, cfg)
        tfm.commit_kv(cache, knew, vnew, S - 1)
        return logits, cache

    return step


# --------------------------------------------------------------- recsys


def recsys_input_specs(arch: ArchSpec, shape: ShapeSpec):
    cfg: b4r.Bert4RecConfig = arch.config
    B = shape.batch
    base = {
        "item_ids": ArraySpec((B, cfg.seq_len), ("dp", None), torch.int32, "zeros"),
        "context_ids": ArraySpec((B, cfg.n_context), ("dp", None), torch.int32, "zeros"),
    }
    if shape.kind == "train":
        base |= {
            "mask_pos": ArraySpec((B, cfg.n_mask), ("dp", None), torch.int32, "zeros"),
            "labels": ArraySpec((B, cfg.n_mask), ("dp", None), torch.int32, "zeros"),
            "negatives": ArraySpec((cfg.n_negatives,), (None,), torch.int32, "zeros"),
            "neg_logq": ArraySpec((cfg.n_negatives,), (None,), torch.float32, "zeros"),
        }
    if shape.kind == "retrieval":
        base |= {
            "candidates": ArraySpec((shape.n_candidates,), ("rows",), torch.int32, "zeros"),
        }
    return base


def recsys_state_specs(arch: ArchSpec, opt_cfg: AdamWConfig):
    """(parameter spec tree, AdamW state spec tree) at the arch's config."""
    pspec_tree = b4r.param_specs(arch.config)
    return pspec_tree, adamw_init_specs(pspec_tree, opt_cfg)


def _topk_at_tied_kth(rows, k: int):
    """:func:`topk_lower_index` of rows [R, n] whose k-th value ties with
    entries past it: ``torch.topk``'s k-th value ``t`` bounds the answer,
    every entry above ``t`` is in it, then the lowest-indexed entries equal
    to ``t`` (one more pass over the rows: ``rows >= t`` and its nonzero
    entries, in index order). Returns (values, indices) [R, k], unordered."""
    R = rows.shape[0]
    t = torch.topk(rows, k, dim=-1).values[:, k - 1]  # [R]
    r, c = torch.nonzero(rows >= t[:, None], as_tuple=True)  # row-major: index order
    v = rows[r, c]
    above = v > t[r]
    ties = (~above).long()
    # each tie's rank within its row: a running count less the count before the row
    count = torch.bincount(r, minlength=R)
    first = torch.cumsum(count, 0) - count
    rank = torch.cumsum(ties, 0) - ties
    rank = rank - rank[first][r]
    need = k - torch.zeros(R, dtype=torch.long, device=rows.device).index_add_(0, r, above.long())
    keep = above | (rank < need[r])
    return v[keep].reshape(R, k), c[keep].reshape(R, k)


def topk_lower_index(x, k: int):
    """``jax.lax.top_k`` over the last axis of ``x``: (values, indices) of the
    ``k`` largest, descending, and among equal values the lower index first
    (at the k-th place too: of the entries equal to the k-th value, the
    lowest-indexed are kept). ``torch.topk`` keeps any of equal values.
    Its ``k + 1`` largest tell which rows it may have chosen wrongly: where
    the (k+1)-th value is below the k-th, the top k are exactly the entries
    at or above the k-th value, and only their order needs fixing; the
    other rows (ties across the k-th place) go through
    :func:`_topk_at_tied_kth`. The k are then ordered by (value descending,
    index ascending)."""
    lead, n = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, n)
    v, i = torch.topk(rows, min(k + 1, n), dim=-1)
    vals, idx = v[:, :k], i[:, :k]
    if n > k and not rows.is_meta:  # meta tensors (the dry-run) hold no values, no ties
        tied = torch.nonzero(v[:, k] == v[:, k - 1]).squeeze(1)
        if tied.numel():
            tv, ti = _topk_at_tied_kth(rows[tied], k)
            vals, idx = vals.index_copy(0, tied, tv), idx.index_copy(0, tied, ti)
    idx, order = torch.sort(idx, dim=-1)
    vals, order = torch.sort(torch.gather(vals, 1, order), dim=-1, descending=True, stable=True)
    return vals.reshape(*lead, k), torch.gather(idx, 1, order).reshape(*lead, k)


def sharded_topk(scores, k: int, shards: int = 16):
    """Two-stage top-k that never sorts the full score row: the top ``k`` of
    each of ``shards`` equal slices (:func:`topk_lower_index`), then the top
    ``k`` of those ``shards * k`` by a stable descending sort; both break
    ties as ``jax.lax.top_k`` does (the lower index, the lower position), so
    the ids are the reference's. Returns (values [B, k], global indices
    [B, k]), values descending."""
    if isinstance(scores, DTensor):
        return _sharded_topk_dtensor(scores, k, shards)
    B, V = scores.shape
    assert V % shards == 0
    s = scores.reshape(B, shards, V // shards)
    v1, i1 = topk_lower_index(s, k)  # [B, shards, k] (local per shard)
    base = (torch.arange(shards, device=scores.device) * (V // shards))[None, :, None]
    gidx = (i1 + base).reshape(B, shards * k)
    v2, i2 = torch.sort(v1.reshape(B, shards * k), dim=-1, descending=True, stable=True)
    return v2[:, :k], torch.gather(gidx, 1, i2[:, :k])


def _sharded_topk_dtensor(scores: DTensor, k: int, shards: int):
    """:func:`sharded_topk` of a [B, V] DTensor whose columns are split over
    some mesh dimensions (``Shard(1)``; the others ``Shard(0)`` or
    ``Replicate``): each rank takes the top ``k`` of its own columns (its
    ``shards / n`` slices, as the plain path does them), the ``n * k``
    candidates of a row are gathered in column order (never the block),
    and a stable descending sort takes the top ``k``. Ties resolve to the
    lower global index at every stage, so the result is the plain path's.
    Returns DTensors [B, k], the rows placed as ``scores``' and the columns
    replicated."""
    mesh, place = scores.device_mesh, tuple(scores.placements)
    if any(p not in (Shard(0), Shard(1), Replicate()) for p in place):
        raise ValueError(f"sharded_topk: placements {place}; want Shard(0), Shard(1) or Replicate")
    cols = [d for d, p in enumerate(place) if p == Shard(1)]
    n = math.prod(mesh.size(d) for d in cols)
    V = scores.shape[1]
    if V % shards or shards % n:
        raise ValueError(f"sharded_topk: {V} columns, {shards} slices, {n} column shards")
    local = scores.to_local()
    if local.shape[1] * n != V:
        raise ValueError(f"sharded_topk: uneven column shards ({local.shape[1]} of {V} over {n})")
    coord = mesh.get_coordinate()
    block = 0  # this rank's column block, the mesh dimensions major to minor
    for d in cols:
        block = block * mesh.size(d) + coord[d]
    v1, i1 = sharded_topk(local, k, shards // n)  # [B_local, k], local columns
    i1 = i1 + block * local.shape[1]
    gathered = [p if p != Shard(1) else Replicate() for p in place]
    v1, i1 = (DTensor.from_local(t, mesh, place, run_check=False).redistribute(mesh, gathered)
              .to_local() for t in (v1, i1))  # [B_local, n * k] in column order
    v2, i2 = torch.sort(v1, dim=-1, descending=True, stable=True)
    out = (v2[:, :k], torch.gather(i1, 1, i2[:, :k]))
    return tuple(DTensor.from_local(t, mesh, gathered, run_check=False) for t in out)


def make_recsys_step(arch: ArchSpec, shape: ShapeSpec, opt_cfg: AdamWConfig | None = None,
                     device=None):
    """The shape's step on ``device`` (None: the card), the batch moved there.

    * ``train``: ``step(model, opt, batch) -> {"loss", "grad_norm"}``, the
      cloze loss (:func:`b4r.loss_fn`), its gradients and one
      :class:`AdamW` step at ``opt_cfg.lr`` (None: the optimizer's); the
      model and the optimizer are updated in place;
    * ``retrieval``: ``step(model, batch) -> (values [B, 100], ids [B,
      100])``, one user's scores against ``batch["candidates"]`` and their
      top 100 (ids index the candidate list);
    * ``serve_scores``: the same outputs for the users in chunks of
      ``min(B, 4096)``, each scored against the full item table (a [4096,
      V] float32 block) and reduced to its top 100 by :func:`sharded_topk`.

    The serving steps record no autograd graph."""
    dev = resolve_device(device)
    cfg: b4r.Bert4RecConfig = arch.config

    if shape.kind == "train":
        lr = None if opt_cfg is None else opt_cfg.lr

        def step(model: b4r.Bert4Rec, opt: AdamW, batch):
            return _descend(opt, b4r.loss_fn(model, {k: v.to(dev) for k, v in batch.items()}), lr)

        return step

    if shape.kind == "retrieval":

        @torch.no_grad()
        def step(model: b4r.Bert4Rec, batch):
            scores = b4r.score_candidates(
                model, batch["item_ids"].to(dev), batch["context_ids"].to(dev),
                batch["candidates"].to(dev))
            return sharded_topk(scores, k=100)

        return step

    B = shape.batch
    user_chunk = min(B, 4096)

    @torch.no_grad()
    def step(model: b4r.Bert4Rec, batch):
        n = B // user_chunk
        users = batch["item_ids"].to(dev)
        ids, ctx = row_chunks(users, n), row_chunks(batch["context_ids"].to(dev), n)
        vals, idxs = [], []
        for i, c in zip(ids, ctx):
            v, ix = sharded_topk(b4r.serve_scores(model, i, c), k=100)
            vals.append(v)
            idxs.append(ix)
        return cat_rows(vals, users), cat_rows(idxs, users)

    return step


def default_opt_cfg(arch: ArchSpec) -> AdamWConfig:
    """The reference's: bf16 Adam moments above 100 B parameters (halves the
    optimizer's memory: grok-1-314b), float32 below."""
    if arch.family == "lm" and arch.config.param_count() > 100e9:
        return AdamWConfig(moment_dtype=torch.bfloat16)
    return AdamWConfig()


# --------------------------------------------------------------- assembly


def _p(rules: dict, *logical) -> PSpec:
    """Resolve logical axis names to a :class:`PSpec` under ``rules``."""
    return PSpec(*resolve(logical, rules))


@dataclasses.dataclass
class BuiltStep:
    """One (arch, shape) step laid out for a mesh, the reference's
    ``BuiltStep`` in torch's terms. ``fn`` is the port's step under
    ``rules``: ``fn(model, opt, batch)`` for the train kinds (the model and
    the optimizer hold ``arg_specs[0]`` and ``arg_specs[1]`` and are updated
    in place), ``fn(model, batch)`` for the serving kinds. ``arg_specs``:
    the argument trees as ``meta`` tensors in call order (parameters,
    optimizer state, batch); ``arg_pspecs`` / ``out_pspecs``: their
    placements as :class:`PSpec` trees; ``donate``: the arguments a step
    updates in place (the model and optimizer state; decode's cache)."""
    fn: Any
    arg_specs: tuple
    arg_pspecs: tuple
    out_pspecs: Any
    donate: tuple
    kind: str
    rules: dict


def build_step(arch: ArchSpec, shape: ShapeSpec, *, multi_pod: bool = False,
               opt_cfg: AdamWConfig | None = None, unroll: bool = False,
               device=None, rules: dict | None = None) -> BuiltStep:
    """The reference's ``build_step``: the step of ``arch`` at ``shape`` on
    ``device`` (None: the card; the dry-run passes ``"meta"``), its argument
    templates and placements under ``rules`` (default :func:`arch_rules`;
    the dry-run's calibration passes the rules of the run it is held to).
    ``unroll`` is accepted and changes nothing (the port's loops are Python
    loops)."""
    del unroll
    opt_cfg = opt_cfg or default_opt_cfg(arch)
    rules = arch_rules(arch, shape, multi_pod) if rules is None else rules
    out_pspecs = None
    donate: tuple = ()
    metrics_ps = {"loss": PSpec(), "grad_norm": PSpec()}
    if arch.family == "lm":
        inputs = lm_input_specs(arch, shape)
        if shape.kind == "train":
            p_t, o_t = lm_state_specs(arch, opt_cfg)
            fn = make_lm_train_step(arch, shape, opt_cfg, device, multi_pod)
            trees = (p_t, o_t, inputs)
            out_pspecs = (pspecs(p_t, rules), pspecs(o_t, rules), metrics_ps)
            donate = (0, 1)
        elif shape.kind == "prefill":
            p_t = tfm.param_specs(arch.config)
            fn = make_lm_prefill(arch, shape, device, multi_pod=multi_pod)
            trees = (p_t, inputs)
            cache_t = lm_input_specs(arch, dataclasses.replace(shape, kind="decode"))["cache"]
            out_pspecs = (pspecs(cache_t, rules), _p(rules, "dp", "vocab"))
        else:
            p_t = tfm.param_specs(arch.config)
            fn = make_lm_decode(arch, shape, device, multi_pod)
            trees = (p_t, inputs)
            out_pspecs = (_p(rules, "cache_batch", "vocab"), pspecs(inputs["cache"], rules))
            donate = (1,)
    elif arch.family == "gnn":
        p_t, o_t = gnn_state_specs(arch, shape, opt_cfg)
        inputs = gnn_input_specs(arch, shape)
        fn = make_gnn_train_step(arch, shape, opt_cfg, device)
        trees = (p_t, o_t, inputs)
        out_pspecs = (pspecs(p_t, rules), pspecs(o_t, rules), metrics_ps)
        donate = (0, 1)
    else:
        inputs = recsys_input_specs(arch, shape)
        fn = make_recsys_step(arch, shape, opt_cfg, device)
        if shape.kind == "train":
            p_t, o_t = recsys_state_specs(arch, opt_cfg)
            trees = (p_t, o_t, inputs)
            out_pspecs = (pspecs(p_t, rules), pspecs(o_t, rules), metrics_ps)
            donate = (0, 1)
        else:
            trees = (b4r.param_specs(arch.config), inputs)
            out_pspecs = (_p(rules, "dp", None), _p(rules, "dp", None))

    def wrapped(*args):
        with sharding_rules(rules):
            return fn(*args)

    return BuiltStep(
        fn=wrapped, arg_specs=tuple(abstract_params(t) for t in trees),
        arg_pspecs=tuple(pspecs(t, rules) for t in trees), out_pspecs=out_pspecs,
        donate=donate, kind=shape.kind, rules=rules,
    )
