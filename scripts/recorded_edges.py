#!/usr/bin/env python3
"""How many edges Part 1 records on the main path, the count Part 2 walks.

    python3 scripts/recorded_edges.py --scales 11 12 13 --device cpu

For each Kronecker scale of the paper's configuration (edge factor 48,
L = 64, eps = 0.1, K = 32, seed 0), runs Part 1 in the blocked order
(``mwm_blocked(backend="kernel")``: the packed per-edge kernel on the card,
its plain version with ``--device cpu``) and prints one JSON line: n, m,
R (the edges with ``assigned >= 0``), R/m and R/n. The plain version is a
Python loop, so keep CPU scales small (scale 13, 254,415 edges, takes
about 10 s).
"""
import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main():
    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import EdgeStream, SubstreamConfig, mwm_blocked
    from repro_torch.graph.generators import kronecker_graph, uniform_weights

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scales", type=int, nargs="+", default=[11, 12, 13])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    for scale in args.scales:
        config = dataclasses.replace(CONFIG, scale=scale)
        src, dst = kronecker_graph(config.scale, config.edge_factor, seed=config.seed)
        w = uniform_weights(src.shape[0], config.L, config.eps, seed=config.seed)
        stream = EdgeStream.from_numpy(src, dst, w, device=args.device)
        cfg = SubstreamConfig(n=1 << scale, L=config.L, eps=config.eps)
        t0 = time.perf_counter()
        result = mwm_blocked(stream, cfg, K=config.K, backend="kernel", device=args.device)
        recorded = int((result.assigned >= 0).sum())
        print(json.dumps({"scale": scale, "n": cfg.n, "m": stream.num_edges,
                          "recorded_edges": recorded, "r_over_m": recorded / stream.num_edges,
                          "r_over_n": recorded / cfg.n, "device": str(stream.device),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
