"""Train GIN on sampled minibatches over the paper's graph substrate:
matching-based coarsening (Part 1 through the packed per-edge kernel on
the card), a symmetrized CSR and the neighbour sampler. The counterpart of
the JAX package's ``examples/gnn_train.py``, with its defaults:

    PYTHONPATH=src python -m repro_torch.launch.gnn_train --steps 20

Each step samples ``n_seeds`` seed nodes, merges the sampled blocks into
one padded subgraph (every sampled node; the hop-0 edges only, as the
reference does) and takes one AdamW step. ``--device cpu`` runs on the
CPU; by default the trainer runs on the CUDA card and raises without one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.graph import CSRGraph, NeighborSampler, coarsen_by_matching
from repro_torch.graph.generators import kronecker_graph, uniform_weights
from repro_torch.launch.steps import train_step
from repro_torch.models.gin import GIN, GINConfig
from repro_torch.models.gnn_common import GraphBatch
from repro_torch.optim import AdamW, AdamWConfig

#: the example's model: GIN 3 layers, d = 32, on 16 features and 8 classes
EXAMPLE_CONFIG = GINConfig(n_layers=3, d_hidden=32, d_in=16, n_classes=8)


def merge_hop0(blocks, seeds, feats, labels, n_pad: int, e_pad: int, device) -> tuple:
    """(GraphBatch, nodes, edges): every node of the last block's table, in
    its (sorted) order, and the hop-0 edges among them in that local id
    space, padded to ``n_pad`` nodes and ``e_pad`` edges."""
    last = blocks[-1]
    nodes = last.nodes[last.node_mask]  # np.unique's output: sorted, distinct
    b0 = blocks[0]
    sel = np.nonzero(b0.edge_mask)[0]
    src_g = b0.nodes[b0.src_index[sel]]
    dst_g = np.asarray(seeds)[b0.dst_index[sel]]
    keep = np.isin(src_g, nodes)
    src_l = np.searchsorted(nodes, src_g[keep]).astype(np.int32)
    dst_k = dst_g[keep]
    pos = np.minimum(np.searchsorted(nodes, dst_k), max(len(nodes) - 1, 0))
    dst_l = np.where(nodes[pos] == dst_k, pos, 0).astype(np.int32)  # unknown ids -> 0
    ne, nn = len(src_l), len(nodes)
    if nn > n_pad or ne > e_pad:
        raise ValueError(f"{nn} nodes / {ne} edges do not fit the pad {n_pad} / {e_pad}")
    t = lambda a: torch.from_numpy(a).to(device)
    return GraphBatch(
        node_feats=t(np.pad(feats[nodes], ((0, n_pad - nn), (0, 0)))),
        src=t(np.pad(src_l, (0, e_pad - ne))),
        dst=t(np.pad(dst_l, (0, e_pad - ne))),
        edge_mask=t(np.arange(e_pad) < ne),
        node_mask=t(np.arange(n_pad) < nn),
        labels=t(np.pad(labels[nodes], (0, n_pad - nn)).astype(np.int32)),
        label_mask=t(np.arange(n_pad) < nn),
    ), nn, ne


class SampledGINTrainer:
    """GIN (``cfg``) on sampled batches of the graph (src, dst, w) over
    ``n`` vertices, on ``device`` (None: the card).

    Set-up, as the reference example: ``coarsen_by_matching(..., L)`` (its
    summary in ``coarsening``), the symmetrized CSR, a
    ``NeighborSampler(fanouts, seed=0)``, the model from ``seed``, and from
    ``np.random.default_rng(seed)`` the node features N(0, 1) [n, d_in],
    the labels [n] and then each step's seeds. ``next_batch()`` samples and
    merges one batch; ``step(batch)`` trains on it.
    """

    def __init__(self, src, dst, w, n: int, cfg: GINConfig = EXAMPLE_CONFIG, *,
                 fanouts=(10, 5), n_seeds: int = 64, n_pad: int = 2048, e_pad: int = 8192,
                 L: int = 16, lr: float = 2e-3, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.n, self.n_seeds, self.n_pad, self.e_pad = n, n_seeds, n_pad, e_pad
        t0 = time.perf_counter()
        mapping, cs, _, _ = coarsen_by_matching(src, dst, w, n=n, L=L, device=self.device)
        self.coarsening = {"n": n, "m": int(len(src)), "coarse_n": int(mapping.max()) + 1,
                           "coarse_m": int(len(cs)), "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        csr = CSRGraph.from_edges(src, dst, w, n=n, symmetrize=True)
        self.sampler = NeighborSampler(csr, fanouts=list(fanouts), seed=0)
        self.csr_seconds = time.perf_counter() - t0
        self.model = GIN(cfg, device=self.device, seed=seed)
        self.opt = AdamW(self.model.parameters(), AdamWConfig(lr=lr))
        self.rng = np.random.default_rng(seed)
        self.feats = self.rng.normal(size=(n, cfg.d_in)).astype(np.float32)
        self.labels = self.rng.integers(0, cfg.n_classes, n)

    def next_batch(self) -> tuple:
        """(GraphBatch on the device, sampled nodes, sampled edges)."""
        seeds = self.rng.integers(0, self.n, self.n_seeds)
        blocks = self.sampler.sample(seeds)
        return merge_hop0(blocks, seeds, self.feats, self.labels, self.n_pad, self.e_pad,
                          self.device)

    def step(self, batch: GraphBatch) -> dict:
        return train_step(self.model, self.opt, batch)

    def run(self, steps: int, log=print) -> list:
        """``steps`` steps; the losses, as floats. Logs every fifth step."""
        losses = []
        for step in range(steps):
            batch, nn, ne = self.next_batch()
            loss = float(self.step(batch)["loss"])
            losses.append(loss)
            if step % 5 == 0 or step == steps - 1:
                log(f"step {step:3d} sampled {nn} nodes / {ne} edges; loss {loss:.4f}")
        return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scale", type=int, default=10, help="Kronecker scale of the graph")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--n-pad", type=int, default=2048)
    ap.add_argument("--e-pad", type=int, default=8192)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    src, dst = kronecker_graph(args.scale, edge_factor=args.edge_factor, seed=0)
    w = uniform_weights(len(src), 16, 0.1, seed=0)
    trainer = SampledGINTrainer(src, dst, w, 1 << args.scale, n_pad=args.n_pad,
                                e_pad=args.e_pad, device=args.device)
    c = trainer.coarsening
    print(f"coarsen-by-matching: {c['n']} -> {c['coarse_n']} vertices "
          f"({c['m']} -> {c['coarse_m']} edges) on {trainer.device}")
    trainer.run(args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
