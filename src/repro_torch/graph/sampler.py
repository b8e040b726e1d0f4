"""Neighbor sampler for sampled-training GNN shapes (minibatch_lg: 15-10).

A *real* fanout sampler over CSR (GraphSAGE-style): given seed nodes,
uniformly sample up to `fanout[h]` neighbors per node per hop, building the
block (bipartite layer) structure used by the models. Padded to static
shapes; pad edges point at a dedicated sink node whose features are zero
and whose messages are masked by `edge_mask`. numpy, with the JAX
package's draws for the same seed (``repro.graph.sampler``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class SampledBlock:
    """One hop: edges from sampled srcs (layer h+1 nodes) into dsts (layer h)."""

    src_index: np.ndarray  # int32 [E_pad]  — indices into this block's node table
    dst_index: np.ndarray  # int32 [E_pad]
    edge_mask: np.ndarray  # bool  [E_pad]
    nodes: np.ndarray  # int64 [N_pad] — global node ids of the block's inputs
    node_mask: np.ndarray  # bool [N_pad]
    num_dst: int


class NeighborSampler:
    def __init__(self, csr: CSRGraph, fanouts: Sequence[int], seed: int = 0):
        self.csr = csr
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> list[SampledBlock]:
        """Returns one SampledBlock per hop, innermost (seeds) first."""
        blocks: list[SampledBlock] = []
        frontier = np.asarray(seeds, np.int64)
        for fanout in self.fanouts:
            nd = frontier.shape[0]
            e_pad = nd * fanout
            srcs = np.zeros(e_pad, np.int64)
            dsts = np.repeat(np.arange(nd, dtype=np.int32), fanout)
            mask = np.zeros(e_pad, bool)
            for i, u in enumerate(frontier):
                nbrs, _ = self.csr.neighbors(int(u))
                if nbrs.shape[0] == 0:
                    continue
                k = min(fanout, nbrs.shape[0])
                pick = self.rng.choice(nbrs, size=k, replace=nbrs.shape[0] < k)
                srcs[i * fanout : i * fanout + k] = pick
                mask[i * fanout : i * fanout + k] = True
            # unique node table: dst nodes first (self features), then srcs
            nodes, inv = np.unique(
                np.concatenate([frontier, srcs[mask]]), return_inverse=True
            )
            remap = {g: j for j, g in enumerate(nodes)}
            src_idx = np.array(
                [remap[g] if ok else len(nodes) for g, ok in zip(srcs, mask)],
                np.int32,
            )
            n_pad = len(nodes) + 1  # +1 sink row for masked edges
            node_tab = np.concatenate([nodes, [0]])
            node_mask = np.concatenate([np.ones(len(nodes), bool), [False]])
            blocks.append(
                SampledBlock(
                    src_index=src_idx,
                    dst_index=dsts,
                    edge_mask=mask,
                    nodes=node_tab,
                    node_mask=node_mask,
                    num_dst=nd,
                )
            )
            frontier = nodes  # next hop expands every block node
        return blocks
