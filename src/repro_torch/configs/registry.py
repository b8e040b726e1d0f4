"""Architecture registry of the port: ``get_arch(<id>)`` resolves here.

Each arch module registers an :class:`ArchSpec` carrying its exact
published config, its shape set and a reduced smoke config; the JAX
package's ``repro.configs.registry``, with all ten of its archs: the five
LMs, the four GNNs and BERT4Rec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

ARCHS: dict[str, "ArchSpec"] = {}

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve_scores | retrieval
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    n_classes: int = 0
    batch_nodes: int = 0
    fanouts: tuple = ()
    batch_graphs: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str  # lm | gnn | recsys
    config: Any  # full published config
    shapes: dict[str, ShapeSpec]
    smoke_config: Any  # reduced config for CPU smoke tests
    source: str  # citation
    gnn_model: Optional[str] = None  # module name under repro_torch.models
    notes: str = ""


def register(spec: ArchSpec) -> ArchSpec:
    ARCHS[spec.id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    import repro_torch.configs  # noqa: F401 — populates ARCHS

    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_arch_ids() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(ARCHS)


# ---- shared shape sets ----------------------------------------------------

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    # decode against a 512k cache is linear in cache length
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train", n_nodes=232965, n_edges=114615892,
        batch_nodes=1024, fanouts=(15, 10), d_feat=602, n_classes=41,
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train", n_nodes=2449029, n_edges=61859140,
        d_feat=100, n_classes=47,
    ),
    "molecule": ShapeSpec(
        "molecule", "train", n_nodes=30, n_edges=64, batch_graphs=128, d_feat=16,
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve_scores", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve_scores", batch=262144),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}


def sampled_subgraph_sizes(shape: ShapeSpec, pad: int = 8192):
    """Static padded (n_nodes, n_edges) of the fanout-sampled block graph."""
    assert shape.fanouts
    frontier = shape.batch_nodes
    tot_edges = 0
    for f in shape.fanouts:
        e = frontier * f
        tot_edges += e
        frontier = frontier + e  # worst case: all sampled nodes distinct
    rup = lambda x: (x + pad - 1) // pad * pad
    return rup(frontier), rup(tot_edges)
