"""End-to-end driver for the paper's system on the port: stream a Kronecker
graph through the custom CSR layout, run Part 1 on the packed per-edge
kernel in lexicographic epoch order, merge on the host, and report the
approximation, the throughput and the paper's DRAM-traffic model, then
checkpoint Part 1's output and restart the merge from it.

    PYTHONPATH=src python -m repro_torch.launch.matching_e2e --scale 10 --L 32

The JAX package's ``examples/matching_e2e.py``, with
``mwm_blocked(backend="kernel")`` where it runs the Pallas kernel. Runs on
the card (``RuntimeError`` without one) unless ``--device cpu`` is asked
for, where the kernel's plain version runs.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (
    EdgeStream,
    SubstreamConfig,
    exact_mwm_weight,
    matching_weight,
    merge_host,
    mwm_blocked,
)
from repro_torch.core.types import resolve_device
from repro_torch.distributed import StragglerMonitor
from repro_torch.graph.csr import CSRGraph, CustomCSR
from repro_torch.graph.generators import kronecker_graph, uniform_weights

#: the exact MWM is computed up to this many vertices, as in the reference
EXACT_MAX_N = 2048


def run(device=None, scale: int = 10, edge_factor: int = 16, L: int = 32, eps: float = 0.1,
        K: int = 32, ckpt_dir: str | None = None) -> dict:
    """Run the driver and print it; returns its numbers (edges, seconds of
    each part, matched edges and weight, the exact weight and ratio where
    n <= EXACT_MAX_N, the straggler event, the restart's step)."""
    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "matching_ckpt")
    n = 1 << scale
    t0 = time.perf_counter()
    src, dst = kronecker_graph(scale, edge_factor, seed=0)
    w = uniform_weights(len(src), L, eps, seed=0)
    csr = CSRGraph.from_edges(src, dst, w, n=n)
    custom = CustomCSR.encode(csr)
    print(f"graph: n={n} m={csr.m}; custom CSR DRAM bytes={custom.dram_bytes}"
          f" ({custom.read_requests_per_edge()} req/edge — §5.11 model)")
    s2, d2, w2 = custom.decode().to_stream_arrays()
    stream = EdgeStream.from_numpy(s2, d2, w2, device=dev)
    cfg = SubstreamConfig(n=n, L=L, eps=eps)
    graph_s = time.perf_counter() - t0

    mon = StragglerMonitor()
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    t0 = time.perf_counter()
    mon.start()
    res = mwm_blocked(stream, cfg, K=K, backend="kernel", device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ev = mon.stop()
    part1_s = time.perf_counter() - t0
    mgr.save(1, {"part1": {"assigned": res.assigned, "mb": res.mb}})
    print(f"Part 1 (kernel, K={K}): {part1_s:.2f}s ({csr.m / part1_s / 1e6:.2f} Me/s on {dev})"
          + (f"; straggler flagged ratio={ev.ratio:.1f}" if ev else ""))

    t0 = time.perf_counter()
    idx = merge_host(stream, res, cfg)
    merge_s = time.perf_counter() - t0
    weight = matching_weight(stream, idx)
    print(f"Part 2 (host merge): {merge_s:.3f}s "
          f"({100 * merge_s / (merge_s + part1_s):.1f}% of total — paper: <1%)")
    print(f"|T|={len(idx)} w(T)={weight:.1f}")
    out = {"n": n, "m": int(csr.m), "dram_bytes": int(custom.dram_bytes),
           "seconds": {"graph": graph_s, "part1": part1_s, "merge": merge_s},
           "matched": int(len(idx)), "weight": weight,
           "straggler": None if ev is None else ev.ratio}
    if n <= EXACT_MAX_N:
        exact = exact_mwm_weight(stream)
        out |= {"exact": exact, "ratio": exact / weight, "bound": 4 + eps}
        print(f"exact={exact:.1f} ratio={exact / weight:.3f} <= {4 + eps}")
    # restart: restore Part 1's output and merge again
    step, state = mgr.restore({"part1": {"assigned": res.assigned, "mb": res.mb}})
    res2 = res.with_assigned(state["part1"]["assigned"].to(dev))
    idx2 = merge_host(stream, res2, cfg)
    if not np.array_equal(idx2, idx):
        raise AssertionError("the merge after the restart differs from the first")
    out["restart_step"] = step
    print(f"checkpoint restart at step {step}: merge reproduced exactly")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--L", type=int, default=32)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--K", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: matching_ckpt in the temporary directory")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    run(args.device, args.scale, args.edge_factor, args.L, args.eps, args.K, args.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
