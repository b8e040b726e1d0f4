"""Part 2 (post processing): greedy merge of the L matchings into the MWM.

The paper runs this on the CPU (<1 % of its time, little parallelism);
so does :func:`merge_host`, in numpy on host copies of the tensors. It is
the reference semantics and ``mwm_pipeline``'s merge on the CPU.
Merging in "descending i, then stream order" is itself a greedy maximal
matching under the total priority order ``(L-1-i, position)``, so a
one-substream Part 1 over the recorded edges in :func:`merge_order`
computes it: that is
:func:`repro_torch.kernels.substream_match.ops.merge_device`, the merge on
the card and ``mwm_pipeline``'s there, which lives beside Part 1's entry
because it launches Part 1's kernel (the JAX package keeps its
``merge_device`` here, over ``mwm_scan``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import EdgeStream, MatchingResult, SubstreamConfig, to_numpy


def merge_host(
    stream: EdgeStream, result: MatchingResult, cfg: SubstreamConfig,
    telemetry=obs.DISABLED,
) -> np.ndarray:
    """Faithful Listing 1 Part 2. Returns the sorted int64 stream indices of T.

    Reads only ``result.assigned``, never the matching bits. The merge
    order "descending substream i, then stream position" is one stable
    argsort over the recorded edges (key ``L-1-i``; stability supplies the
    stream-position minor key), then one greedy pass over those edges. The
    greedy pass is the dependency chain and stays a loop, like the paper's
    sequential post-processor.

    ``telemetry`` (resolved by :func:`repro_torch.obs.active`) records one
    ``merge.host`` span holding ``merge.d2h`` (``assigned`` to the host;
    arg ``bytes``), ``merge.order`` (the recorded edges in merge order and
    their endpoints on the host; arg ``recorded``, R) and ``merge.greedy``
    (the loop; args ``recorded`` and ``matched``), plus the recorded /
    matched edge counters.
    """
    telemetry = obs.active(telemetry)
    with telemetry.span("merge.host"):
        with telemetry.span("merge.d2h", sync=result.assigned) as span:
            if telemetry.enabled:
                span.note(bytes=result.assigned.nbytes)
            assigned = to_numpy(result.assigned)
        with telemetry.span("merge.order") as span:
            recorded = np.nonzero(assigned >= 0)[0]
            order = recorded[np.argsort(cfg.L - 1 - assigned[recorded], kind="stable")]
            src = to_numpy(stream.src)[order].tolist()
            dst = to_numpy(stream.dst)[order].tolist()
            if telemetry.enabled:
                span.note(recorded=int(recorded.size))
        with telemetry.span("merge.greedy") as span:
            out = []
            if recorded.size:
                # empty / all-dropped streams skip the n-sized allocation (n may be 0)
                tbits = bytearray(cfg.n)
                for e, u, v in zip(order.tolist(), src, dst):
                    if not tbits[u] and not tbits[v]:
                        tbits[u] = tbits[v] = 1
                        out.append(e)
            merged = np.sort(np.asarray(out, dtype=np.int64))
            if telemetry.enabled:
                span.note(recorded=int(recorded.size), matched=int(merged.size))
    if telemetry.enabled:
        telemetry.counters.add("merge.host.calls")
        telemetry.counters.put("merge.recorded_edges", int(recorded.size))
        telemetry.counters.put("merge.matched_edges", int(merged.size))
    return merged


def merge_order(result: MatchingResult, cfg: SubstreamConfig) -> torch.Tensor:
    """int64 stream positions of the R recorded edges in merge order:
    descending substream, then stream position (one stable sort of the
    recorded positions, ascending already, by ``L-1-assigned``)."""
    assigned = result.assigned
    recorded = torch.nonzero(assigned >= 0).flatten()
    _, perm = torch.sort((cfg.L - 1) - assigned[recorded], stable=True)
    return recorded[perm]


def matching_weight(stream: EdgeStream, edge_idx: np.ndarray) -> float:
    """float32 sum of the weights at ``edge_idx``, as a Python float."""
    idx = np.asarray(edge_idx, dtype=np.int64)
    if idx.size == 0:
        return 0.0
    return float(to_numpy(stream.weight)[idx].sum())
