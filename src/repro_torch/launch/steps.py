"""(arch x shape) -> GNN train steps: the GNN half of the JAX package's
``repro.launch.steps``.

For each GNN architecture it builds the shape's config
(:func:`gnn_shape_config`), the padded batch dimensions
(:func:`gnn_batch_dims`), the spec trees of one step's inputs and state,
the model, and a train step (:func:`make_gnn_train_step`). The LM and
recsys halves (prefill, decode, serving) and ``arch_rules`` (the
logical-axis -> mesh-axis map of the dry-run) are not ported yet
(ROADMAP.md §1 item 14).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.configs.registry import ArchSpec, ShapeSpec, sampled_subgraph_sizes
from repro_torch.core.types import resolve_device
from repro_torch.models.gnn_common import GraphBatch
from repro_torch.models.param import ArraySpec
from repro_torch.optim import AdamW, AdamWConfig, adamw_init_specs

N_SRC_BLOCKS = 16  # paper-style blocking: one node block resident/chunk


def _gnn_module(arch: ArchSpec):
    return importlib.import_module(f"repro_torch.models.{arch.gnn_model}")


def _rup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


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


def train_step(model, opt: AdamW, batch: GraphBatch, lr: float | None = None) -> dict:
    """One step on the batch's device: the loss, its gradients, one
    :class:`AdamW` step (at ``lr``, else the optimizer's); ``{"loss",
    "grad_norm"}`` (the norm before clipping). Updates in place."""
    loss = model.loss_fn(batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    return {"loss": loss.detach(), "grad_norm": opt.step(lr=lr)}


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
