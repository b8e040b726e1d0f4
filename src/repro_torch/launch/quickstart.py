"""Quickstart: substream-centric (4+eps)-approximate maximum weighted matching.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The JAX package's ``examples/quickstart.py`` on the port: a Kronecker graph
(scale 8, edge factor 8, L = 16, eps = 0.1) through the four Part-1
engines of ``mwm_pipeline`` (``"scan"``, ``"blocked"``, ``"rounds"`` and
``"kernel"``, the JAX package's ``"pallas"``: the blocked order through
the packed per-edge kernel on the card), the exact MWM and the
approximation ratio, and the H100 plan of the packed bit block
(``ops.device_plan``) where the reference prints its VMEM plan. Runs on
the card (``RuntimeError`` without one) unless ``--device cpu`` is asked
for, where the kernel's plain version runs.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import EdgeStream, SubstreamConfig, exact_mwm_weight, mwm_pipeline
from repro_torch.core.types import resolve_device
from repro_torch.graph.generators import kronecker_graph, uniform_weights
from repro_torch.kernels.substream_match.ops import L2_BYTES, device_plan

VARIANTS = ("scan", "blocked", "rounds", "kernel")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, scale: int = 8, edge_factor: int = 8, L: int = 16, eps: float = 0.1,
        seed: int = 0) -> dict:
    """Run the quickstart and print it; returns its numbers: per variant the
    matched edges, weight and seconds, the exact weight, the ratio of the
    default pipeline, and the plan."""
    dev = resolve_device(device)
    src, dst = kronecker_graph(scale=scale, edge_factor=edge_factor, seed=seed)
    w = uniform_weights(len(src), L, eps, seed=seed)
    stream = EdgeStream.from_numpy(src, dst, w, device=dev)
    cfg = SubstreamConfig(n=1 << scale, L=L, eps=eps)
    out = {"m": int(len(src)), "n": cfg.n, "variants": {}}
    for variant in VARIANTS:
        t0 = time.perf_counter()
        idx, weight = mwm_pipeline(stream, cfg, part1=variant, device=dev)
        _sync(dev)
        secs = time.perf_counter() - t0
        out["variants"][variant] = {"matched": int(len(idx)), "weight": weight, "seconds": secs}
        print(f"{variant:8s}: |T|={len(idx):4d}  w(T)={weight:9.2f}  ({secs:.3f} s)")
    t0 = time.perf_counter()
    exact = exact_mwm_weight(stream)
    out["exact_seconds"] = time.perf_counter() - t0
    idx, weight = mwm_pipeline(stream, cfg, device=dev)
    out |= {"exact": exact, "weight": weight, "ratio": exact / weight, "bound": 4 + eps}
    print(f"exact MWM weight {exact:.2f}; ratio {exact / weight:.3f} (guarantee <= {4 + eps})")
    plan = device_plan(cfg.n, cfg.L)
    per_l2 = L2_BYTES // plan.width
    unpacked = L2_BYTES // device_plan(cfg.n, cfg.L, packed=False).width
    out["plan"] = {"nbytes": plan.nbytes, "width": plan.width, "fits_l2": plan.fits_l2,
                   "l2_vertices": per_l2, "l2_vertices_unpacked": unpacked}
    print(f"packed bit block: {plan.nbytes} B ({plan.width} B/vertex); vertices whose rows "
          f"fit the H100's 50 MiB L2 at L={L}: {per_l2:,} ({per_l2 // unpacked}x unpacked)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--eps", type=float, default=0.1)
    args = ap.parse_args(argv)
    run(args.device, args.scale, args.edge_factor, args.L, args.eps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
