"""Card only: Part 1's rounds engine against the one-CTA walker (row 1) on
the main path's blocked streams.

    python3 scripts/rounds_engine.py [--cells s16,s20,g500] [--sweep] [--seed N]

For each cell's stream (drawn on the card by the benchmark's generators,
put in the blocked order): both engines' time (CUDA events, the median of
``--reps`` runs, each from a fresh block), the bits compared, the rounds
engine's chunks and rounds, and the main path's device peak while Part 1
runs on the rounds engine against the peak set before it (the blocking's).
``--sweep`` times both on prefixes of the 2^20-vertex stream, 2^9 to 2^21
edges: where the rounds engine overtakes the walker. One JSON line a
result on stdout. The split and the engines run outside the main path, so
their slices are sized from whatever peak the script has reached; the
peaks' run is the main path's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.gen import graph500, rmat  # noqa: E402
from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline  # noqa: E402
from repro_torch.core.blocked import lexicographic_order, permute_stream  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.substream_match import kernel, ops  # noqa: E402

CELLS = {"s16": ("kron48-L64", rmat, 16), "s20": ("kron48-L64", rmat, 20),
         "g500": ("graph500-L64", graph500, 23)}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                        "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": q.stdout.strip()}


def blocked_stream(cell: str, seed: int):
    name, gen, scale = CELLS[cell]
    config = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    src, dst, w = gen.generate(config, scale, torch.Generator(device="cuda").manual_seed(seed))
    stream = EdgeStream(src, dst, w, torch.ones(src.shape, dtype=torch.bool, device=src.device))
    cfg = SubstreamConfig(n=1 << scale, L=config["L"], eps=config["eps"])
    return stream, permute_stream(stream, lexicographic_order(stream, config["K"])), cfg


def timed(fn, reps: int):
    """(median ms over ``reps`` runs after one warm-up, the last result)."""
    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def engines(args, reps: int, walker_reps: int | None = None):
    """Both engines on ``args``: their ms, equal bits, and the rounds engine's
    chunks and rounds."""
    dev = args[0].device
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    kernel.substream_match_rounds(*args, stats=stats)
    chunks, rounds = stats.tolist()
    r_ms, (r_a, r_mb) = timed(lambda: kernel.substream_match_rounds(*args), reps)
    w_ms, (w_a, w_mb) = timed(lambda: kernel.substream_match_packed(*args),
                              walker_reps or reps)
    return {"m": int(args[0].shape[0]), "walker_ms": w_ms, "rounds_ms": r_ms,
            "speedup": w_ms / r_ms, "equal": bool(torch.equal(r_a, w_a) and torch.equal(r_mb, w_mb)),
            "chunks": chunks, "rounds": rounds, "rounds_per_chunk": rounds / max(chunks, 1),
            "rounds_ns_per_edge": r_ms * 1e6 / max(int(args[0].shape[0]), 1)}


def split(args, reps: int):
    """The rounds engine's wrapper loop with its three steps timed apart
    (CUDA events, summed over the slices; the median of ``reps`` runs): the
    keys kernel, ``torch.sort``, the cooperative launch."""
    edges, w, thr, n_pad, _ = args
    m = edges.shape[0]
    keys_fn, run_fn = kernel._rounds_launchers()
    chunk, slice_edges, vbits = kernel.rounds_geometry(
        m, n_pad, kernel.group_budget(edges.device), kernel.rounds_blocks(edges.device))
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for _ in range(reps + 1):
        mb = torch.zeros((n_pad, 8), dtype=torch.uint8, device=edges.device)
        assigned = torch.empty((m,), dtype=torch.int32, device=edges.device)
        scratch = torch.empty((kernel.ROUNDS_SCRATCH_WORDS,), dtype=torch.int64, device=edges.device)
        stats = torch.zeros(2, dtype=torch.int64, device=edges.device)
        ev = []
        for lo in range(0, m, slice_edges):
            n = min(m, lo + slice_edges) - lo
            e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            e[0].record()
            keys = torch.empty((2 * n,), dtype=torch.int32, device=edges.device)
            keys_fn(edges[lo:].data_ptr(), keys.data_ptr(), n, chunk, vbits, stream)
            e[1].record()
            keys, perm = torch.sort(keys, stable=True)
            e[2].record()
            scratch[kernel.EDGE_ROUNDS_CHUNK:].zero_()
            run_fn(edges[lo:].data_ptr(), w[lo:].data_ptr(), thr.data_ptr(), mb.data_ptr(),
                   assigned[lo:].data_ptr(), keys.data_ptr(), perm.data_ptr(), n, chunk,
                   thr.shape[1], vbits, scratch.data_ptr(), stats.data_ptr(), stream)
            e[3].record()
            ev.append(e)
            del keys, perm
        torch.cuda.synchronize()
        runs.append([sum(x[i].elapsed_time(x[i + 1]) for x in ev) for i in range(3)])
    med = [statistics.median(r[i] for r in runs[1:]) for i in range(3)]
    return {"keys_ms": med[0], "sort_ms": med[1], "rounds_kernel_ms": med[2],
            "slices": -(-m // slice_edges), "chunk": chunk, "slice_edges": slice_edges}


def sort_bytes():
    """Device bytes ``torch.sort(stable=True)`` of int32 keys takes beyond its
    input, per key: the peak over the call less what was allocated before."""
    out = {}
    for n in (1 << 18, 1 << 22, 1 << 24):
        keys = torch.randint(0, 1 << 30, (n,), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s, p = torch.sort(keys, stable=True)
        torch.cuda.synchronize()
        out[str(n)] = (torch.cuda.max_memory_allocated() - base) / n
        del s, p, keys
    return out


def peaks(stream, cfg):
    """The main path's peak before Part 1 and during it (rounds engine)."""
    seen = {}
    engine = ops._rounds_device

    def measured(args, stats=None):  # no reset: the engine sizes its slices from the peak
        torch.cuda.synchronize()
        seen["before_part1"] = torch.cuda.max_memory_allocated()
        seen["live_at_part1"] = torch.cuda.memory_allocated()
        seen["slices"] = build.launches[kernel.ROUNDS_NAME]
        out = engine(args, stats)
        torch.cuda.synchronize()
        seen["part1"] = torch.cuda.max_memory_allocated()
        seen["slices"] = build.launches[kernel.ROUNDS_NAME] - seen["slices"]
        return out

    ops._rounds_device = measured
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mwm_pipeline(stream, cfg, part1="kernel")
        torch.cuda.synchronize()
    finally:
        ops._rounds_device = engine
    seen["part1_under_before"] = seen["part1"] <= seen["before_part1"]
    seen["bytes_per_edge_before"] = seen["before_part1"] / stream.num_edges
    seen["bytes_per_edge_part1"] = seen["part1"] / stream.num_edges
    seen["headroom_bytes_per_edge"] = (seen["before_part1"] - seen["live_at_part1"]) / stream.num_edges
    return seen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="s16,s20,g500")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    emit(phase="card", **card())
    kernel.substream_match_rounds(*ops.kernel_inputs(*blocked_stream("s16", 1)[1:]))
    torch.cuda.synchronize()
    emit(phase="build", builds={k: {"seconds": v["seconds"], "built": v["built"]}
                                for k, v in build.builds.items()},
         ptxas=build.builds[kernel.EDGES_LIBRARY]["ptxas"][-3000:])
    emit(phase="sort_bytes_per_key", **sort_bytes())
    for cell in filter(None, a.cells.split(",")):
        stream, blocked, cfg = blocked_stream(cell, a.seed)
        args = ops.kernel_inputs(blocked, cfg)
        emit(phase="engines", cell=cell, **engines(args, a.reps, 1 if cell == "g500" else None))
        emit(phase="split", cell=cell, **split(args, a.reps))
        del args, blocked
        emit(phase="peaks", cell=cell, m=stream.num_edges, **peaks(stream, cfg))
        del stream
        torch.cuda.empty_cache()
    if a.sweep:
        _, blocked, cfg = blocked_stream("s20", a.seed)
        full = ops.kernel_inputs(blocked, cfg)
        for k in range(9, 22):
            m = 1 << k
            args = (full[0][:m], full[1][:m], *full[2:])
            emit(phase="sweep", **engines(args, 21 if m <= 1 << 16 else 5))


if __name__ == "__main__":
    main()
