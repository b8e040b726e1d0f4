"""Roofline model of the substream-matching kernels on one NVIDIA H100.

The JAX package's ``repro.launch.roofline`` holds this model for a TPU
v5e core beside the parsing of compiled dry-run artifacts (HLO costs and
collectives); only the model is ported here, recast for the H100
(the dry-run tooling is ROADMAP.md §1 item 14). One term, in edges per
second:

  memory = HBM_BW / bytes_per_edge

The reference's second term, a pipeline bound of a fixed cycle count an
edge at the core clock, counts the TPU's vector pipeline; no such count
has been measured on the card, so the port's bound is the bytes term
alone and ``pipeline_edges_per_s`` is infinite (the key stays, so the
terms have the reference's keys).

Consumed by :meth:`repro_torch.obs.report.MatchTelemetry.roofline`.
"""
from __future__ import annotations

#: bytes/s of HBM3 on one H100 SXM (NVIDIA H100 data sheet, 3.35 TB/s);
#: the memory term ``chip_smoke.py`` computes its bounds with
HBM_BW = 3.35e12


def substream_bound(bytes_per_edge: float) -> dict:
    """Edges/sec roofline of the substream kernels at the given traffic:
    the HBM bound (stream and bit-row traffic, ``bytes_per_edge`` per
    edge). ``bytes_per_edge <= 0`` leaves no bound (infinite)."""
    memory = HBM_BW / bytes_per_edge if bytes_per_edge > 0 else float("inf")
    return {
        "pipeline_edges_per_s": float("inf"),
        "memory_edges_per_s": memory,
        "bound_edges_per_s": memory,
        "dominant": "memory",
        "bytes_per_edge": bytes_per_edge,
    }


def substream_achieved(edges_per_sec: float, bytes_per_edge: float) -> dict:
    """:func:`substream_bound` terms plus the achieved fraction."""
    terms = substream_bound(bytes_per_edge)
    terms["achieved_edges_per_s"] = edges_per_sec
    terms["achieved_fraction"] = edges_per_sec / terms["bound_edges_per_s"]
    return terms
