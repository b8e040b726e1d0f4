"""Roofline model of the dry-run on one NVIDIA H100, the JAX package's
``repro.launch.roofline`` recast for the card.

The dry-run's terms (``launch/dryrun.py``) are per-step times in seconds
from a record's per-device counts: compute = FLOPs / PEAK_FLOPS, memory =
bytes / HBM_BW, collective = collective bytes / LINK_BW, the collective
bytes priced by the reference's ring formulas (:func:`collective_bytes`)
over the collectives a traced step issued (there is no HLO to parse).
"""
from __future__ import annotations

#: bytes/s of HBM3 on one H100 SXM (NVIDIA H100 data sheet, 3.35 TB/s); the
#: one copy in the port, read also by ``chip_smoke.py``'s kernel bounds and
#: ``scripts/gnn_step_profile.py``'s ops
HBM_BW = 3.35e12

#: bf16 dense FLOP/s of one H100 SXM (NVIDIA H100 data sheet, no sparsity)
PEAK_FLOPS = 989e12
#: bytes/s one device sends over the link that bounds a 16-wide mesh axis:
#: an axis of 16 spans two hosts of 8 (NVIDIA DGX H100), so its ring crosses
#: the hosts' InfiniBand, one ConnectX-7 port of 400 Gb/s (50 GB/s) a GPU,
#: not NVLink's 450 GB/s each way within a host
LINK_BW = 50e9

#: the kinds of collective the terms count, as the reference names them
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


def collective_bytes(kind: str, nbytes: float, g: int) -> float:
    """Bytes one device moves for one collective whose result is ``nbytes``
    on a group of ``g``, by the reference's ring formulas: all-reduce
    2·b·(g−1)/g, all-gather b·(g−1)/g, reduce-scatter b·(g−1) (its result
    is the scattered piece), all-to-all b·(g−1)/g, collective-permute b."""
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


def collective_totals(records) -> dict:
    """``{kind: bytes moved per device}`` over ``records`` of ``(kind,
    result bytes, group size)``, with ``total_bytes_per_device`` and
    ``n_ops``: the reference's ``collective_bytes_from_hlo`` over the
    collectives a traced step issued."""
    out: dict[str, float] = {}
    count = 0
    for kind, nbytes, g in records:
        if nbytes == 0:
            continue
        out[kind] = out.get(kind, 0.0) + collective_bytes(kind, nbytes, g)
        count += 1
    out["total_bytes_per_device"] = sum(out.values())
    out["n_ops"] = count
    return out


def roofline_terms(rec: dict) -> dict:
    """Per-step times of a dry-run record (per-device FLOPs, bytes and
    collective bytes) at the H100's peaks, the dominant term, the step's
    lower bound, and against ``model_flops``: the useful share of the
    counted FLOPs and the roofline fraction."""
    fpd = max(rec.get("flops_per_device", 0), 0)
    bpd = max(rec.get("bytes_per_device", 0), 0)
    cpd = rec.get("collectives", {}).get("total_bytes_per_device", 0)
    compute_s = fpd / PEAK_FLOPS
    memory_s = bpd / HBM_BW
    coll_s = cpd / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, coll_s)
    mf = rec.get("model_flops", 0)
    n_chips = rec.get("n_chips", 1)
    terms["dominant"] = dom
    terms["step_time_lower_bound_s"] = bound
    if mf and fpd > 0:
        terms["useful_flop_ratio"] = mf / (fpd * n_chips)
        terms["roofline_fraction"] = (mf / (n_chips * PEAK_FLOPS)) / bound if bound else 0.0
    return terms


def useful_flops(arch, shape) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N = active params.

    GNNs: parameter-matmul work per node/edge, x3 for bwd. Rough by design:
    it is the sanity ratio against the counted FLOPs, not a score.
    """
    fam = arch.family
    if fam == "lm":
        cfg = arch.config
        n_act = cfg.active_param_count()
        if shape.kind == "train":
            return 6.0 * n_act * shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            return 2.0 * n_act * shape.global_batch * shape.seq_len
        # decode: one token per sequence + attention over the cache
        attn = (
            2.0 * cfg.n_layers * cfg.n_kv * cfg.d_head * 2 * shape.seq_len
            * shape.global_batch
        )
        return 2.0 * n_act * shape.global_batch + attn
    if fam == "recsys":
        cfg = arch.config
        d = cfg.embed_dim
        enc = cfg.n_blocks * (4 * d * d + 8 * d * d)  # attn + ffn per token
        attn = cfg.n_blocks * 2 * cfg.seq_len * d  # score+mix per token
        per_seq = cfg.seq_len * (enc + attn)
        if shape.kind == "train":
            head = cfg.n_mask * (1 + cfg.n_negatives) * d * 2
            return 3.0 * shape.batch * (per_seq + head)
        if shape.kind == "retrieval":
            return shape.batch * per_seq + 2.0 * shape.n_candidates * d
        return shape.batch * (per_seq + 2.0 * cfg.item_vocab * d)
    # gnn
    from repro_torch.launch.steps import gnn_batch_dims, gnn_shape_config

    cfg = gnn_shape_config(arch, shape)
    N, E = gnn_batch_dims(shape)
    d = cfg.d_hidden
    if arch.id == "gin-tu":
        per_node = 2 * (cfg.d_in * d + cfg.n_layers * 2 * d * d)
        per_edge = cfg.n_layers * d
        fwd = N * per_node + E * per_edge
    elif arch.id == "egnn":
        per_edge = cfg.n_layers * 2 * ((2 * d + 1) * d + d * d + d * d + d)
        per_node = cfg.n_layers * 2 * (2 * d * d + d * d)
        fwd = N * per_node + E * per_edge
    elif arch.id == "meshgraphnet":
        per_edge = cfg.n_layers * 2 * (3 * d * d + d * d + d * d)
        per_node = cfg.n_layers * 2 * (2 * d * d + d * d + d * d)
        fwd = N * per_node + E * per_edge
    else:  # equiformer-v2
        n_m = cfg.m_max + 1
        so2 = (cfg.l_max + 1) * d * d + sum(
            (cfg.l_max + 1 - m) * (2 * d) * (2 * d) for m in range(1, n_m)
        )
        per_edge = cfg.n_layers * 2 * 2 * so2  # x2 two-pass softmax
        per_node = cfg.n_layers * 2 * (cfg.n_heads * d * d + (cfg.l_max + 1) * d * d)
        fwd = N * per_node + E * per_edge
    return 3.0 * fwd
