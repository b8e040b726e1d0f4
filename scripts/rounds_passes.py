#!/usr/bin/env python3
"""Where a round of the parallel-rounds engine spends its time, on one NVIDIA card.

    python3 scripts/rounds_passes.py [--scale 20] [--blocked-cap 400]

``repro_torch.core.rounds`` runs each round as three passes: the kill
(clear the live bits of edges with a matched endpoint: two gathers of the
endpoints' rows over the edges), the vertex minimum (a scatter-min of the
live priorities over the edges) and the acceptance (from the vertex side:
gathers over [n, L], no scatter of bits). This script drives that
loop on the paper configuration at ``--scale`` in the generated order,
times each pass of every round with CUDA events, and counts the live
(edge, substream) bits and the live edges at the start of each round: the
share a compaction of the live edges would keep. It runs the loop twice,
each held to ``mwm_rounds`` bit for bit:

* ``engine``: the engine's own passes;
* ``first``: the first design's acceptance, from the edge side: the
  winners' uint8 bits scattered into the block with ``"amax"``
  (``scatter_reduce_``, emulated on the card with a 32-bit CAS).

Then ``mwm_rounds`` on the blocked order (K = 32), capped at
``--blocked-cap`` rounds: rounds, seconds, converged. One JSON line per
round and variant, then a summary line; peak memory from
``torch.cuda.max_memory_allocated`` (the counting itself takes a chunk's
int64 sum). Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _accept_amax(alive, pri, src, dst, best, assigned, chunks):
    import torch

    from repro_torch.core.matching import highest_lane

    n, L = best.shape
    new = torch.zeros((n, L), dtype=torch.uint8, device=best.device)
    for a, b in chunks:
        p = pri[a:b, None]
        win = alive[a:b] & (best[src[a:b]] == p) & (best[dst[a:b]] == p)
        won = win.to(torch.uint8)
        for ends in (src, dst):
            new.scatter_reduce_(0, ends[a:b, None].expand(-1, L), won, "amax")
        assigned[a:b] = torch.maximum(assigned[a:b], highest_lane(win))
    return new


def _loop(stream, cfg, variant, cuda_ms):
    """The engine's loop with pass timings and live counts per round."""
    import torch

    from repro_torch.core import rounds as R

    thr = torch.tensor(cfg.thresholds(), device=stream.device)
    te, src, dst = R._operands(stream, thr)
    m, L = te.shape
    pri = torch.arange(m, dtype=torch.int32, device=te.device)
    alive = te
    mb = torch.zeros((cfg.n, L), dtype=torch.bool, device=te.device)
    assigned = torch.full((m,), -1, dtype=torch.int32, device=te.device)
    chunks = R._chunks(m, L)
    rows, k = [], 0
    while True:
        kill_ms, live = cuda_ms(lambda: R._kill(alive, mb if k else None, src, dst, chunks))
        bits_live = sum(int(alive[a:b].sum()) for a, b in chunks)
        edges_live = int(alive.any(dim=1).sum())
        if not bool(live):
            break
        min_ms, best = cuda_ms(lambda: R._vertex_min(alive, pri, src, dst, cfg.n, chunks))
        if variant == "engine":
            acc_ms, won = cuda_ms(lambda: R._accept(best, src, dst, 0, 0, assigned))
        else:
            acc_ms, won = cuda_ms(lambda: _accept_amax(alive, pri, src, dst, best, assigned, chunks))
        mb |= won.bool()
        rows.append({"round": k, "bits_live": bits_live, "edges_live": edges_live,
                     "kill_ms": kill_ms, "vertex_min_ms": min_ms, "accept_ms": acc_ms})
        k += 1
    return rows, assigned, mb


def main():
    import torch

    from repro_torch import obs
    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import (
        EdgeStream, SubstreamConfig, lexicographic_order, mwm_rounds, permute_stream,
    )
    from repro_torch.graph.generators import kronecker_graph, uniform_weights

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--blocked-cap", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rounds_passes: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    config = dataclasses.replace(CONFIG, scale=args.scale)
    src, dst = kronecker_graph(config.scale, config.edge_factor, seed=config.seed)
    w = uniform_weights(src.shape[0], config.L, config.eps, seed=config.seed)
    stream = EdgeStream.from_numpy(src, dst, w)
    cfg = SubstreamConfig(n=1 << config.scale, L=config.L, eps=config.eps)
    m = stream.num_edges

    def cuda_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    torch.cuda.reset_peak_memory_stats()
    tel = obs.Telemetry()
    whole_ms, want = cuda_ms(lambda: mwm_rounds(stream, cfg, telemetry=tel))
    rec = tel.match_calls[-1].counters
    summary = {"scale": config.scale, "m": m, "n": cfg.n, "L": cfg.L, "nvidia_smi": smi,
               "generated": {"rounds": rec["rounds.rounds"], "ms": whole_ms,
                             "max_memory_allocated": torch.cuda.max_memory_allocated()}}
    for variant in ("engine", "first"):
        torch.cuda.reset_peak_memory_stats()
        rows, assigned, mb = _loop(stream, cfg, variant, cuda_ms)
        if not (torch.equal(assigned, want.assigned) and torch.equal(mb, want.mb)):
            raise AssertionError(f"the {variant} loop differs from mwm_rounds")
        for row in rows:
            print(json.dumps({"order": "generated", "variant": variant, **row}), flush=True)
        summary["generated"][variant] = {
            "rounds": len(rows), "max_memory_allocated": torch.cuda.max_memory_allocated(),
            **{k: sum(r[k] for r in rows) for k in ("kill_ms", "vertex_min_ms", "accept_ms")}}
    del want
    blocked = permute_stream(stream, lexicographic_order(stream, config.K))
    del stream
    tel = obs.Telemetry()
    t0 = time.perf_counter()
    ms, _ = cuda_ms(lambda: mwm_rounds(blocked, cfg, max_rounds=args.blocked_cap, telemetry=tel))
    rec = tel.match_calls[-1].counters
    summary["blocked"] = {"rounds": rec["rounds.rounds"], "converged": rec["rounds.converged"],
                          "cap": args.blocked_cap, "ms": ms, "wall_s": time.perf_counter() - t0}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
