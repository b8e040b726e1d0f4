"""Partitioners for distributed matching / GNN training (numpy, the JAX
package's ``repro.graph.partition``)."""
from __future__ import annotations

import numpy as np


def partition_edges(src, dst, weight, num_parts: int, pad_to_multiple: int = 8):
    """Round-robin-free contiguous edge partition preserving stream order.

    Returns (src_p, dst_p, w_p, valid_p) each shaped [num_parts, m_part],
    one row per edge shard; stream priority is (part * m_part + local_idx),
    the convention of :func:`repro_torch.core.rounds.mwm_rounds_sharded`.
    """
    m = len(src)
    m_part = -(-m // num_parts)
    m_part = -(-m_part // pad_to_multiple) * pad_to_multiple
    tot = m_part * num_parts
    pad = tot - m

    def padcat(x, fill=0, dtype=None):
        x = np.asarray(x)
        out = np.concatenate([x, np.full(pad, fill, x.dtype if dtype is None else dtype)])
        return out.reshape(num_parts, m_part)

    valid = np.concatenate([np.ones(m, bool), np.zeros(pad, bool)]).reshape(
        num_parts, m_part
    )
    return padcat(src), padcat(dst), padcat(weight, 0.0), valid


def partition_vertices(n: int, num_parts: int):
    """Contiguous vertex ranges [start, end) per part."""
    step = -(-n // num_parts)
    return [(p * step, min(n, (p + 1) * step)) for p in range(num_parts)]
