"""G-SEQ: the Ghaffari / Paz–Schwartzman (2+eps) semi-streaming MWM
baseline the paper compares against (§5.1.1, [62]). Local-ratio scheme:

  for each streamed edge e=(u,v,w):
      if w >= (1+eps) * (phi[u] + phi[v]):
          g = w - phi[u] - phi[v]
          push e (stack);  phi[u] += g;  phi[v] += g
  unwind the stack, greedily keeping edges whose endpoints are free.

Space O(n log n) bits + stack; one pass. Approximation (2 + eps). The pass
is a plain loop on the stream's device, in float32 and in the JAX
package's order of operations, so ``kept`` is exact against it; the unwind
runs on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import EdgeStream, resolve_device, to_numpy


def gseq_pass(stream: EdgeStream, n: int, eps: float) -> torch.Tensor:
    """bool [m]: the edges the local-ratio pass pushes, on the stream's device.

    ``1 + eps`` is one float32 constant (the JAX package's weak-typed
    constant rounds so), and ``g = (w - phi[u]) - phi[v]``. Self-loops and
    invalid edges are never pushed and change no ``phi``.
    """
    dev = stream.device
    phi = torch.zeros(n, dtype=torch.float32, device=dev)
    factor = torch.tensor(1.0 + eps, dtype=torch.float32, device=dev)
    kept = torch.zeros(stream.num_edges, dtype=torch.bool, device=dev)
    weight = stream.weight.to(torch.float32)
    ends = zip(stream.src.tolist(), stream.dst.tolist(), stream.valid.tolist())
    for i, (u, v, ok) in enumerate(ends):
        if u == v or not ok:
            continue
        w, pu, pv = weight[i], phi[u], phi[v]
        keep = w >= factor * (pu + pv)
        g = torch.where(keep, w - pu - pv, 0.0)
        phi[u] += g
        phi[v] += g
        kept[i] = keep
    return kept


def gseq(stream: EdgeStream, n: int, eps: float = 0.1, device=None) -> np.ndarray:
    """Sorted int64 stream indices of the (2+eps)-approximate matching.
    ``device=None`` runs the pass on the card."""
    stream = stream.to(resolve_device(device))
    kept = to_numpy(gseq_pass(stream, n, eps))
    src = to_numpy(stream.src)
    dst = to_numpy(stream.dst)
    used = np.zeros(n, bool)
    out = []
    for e in np.nonzero(kept)[0][::-1]:  # unwind the stack (reverse order)
        u, v = src[e], dst[e]
        if not used[u] and not used[v]:
            used[u] = True
            used[v] = True
            out.append(e)
    return np.asarray(sorted(out), dtype=np.int64)
