#!/usr/bin/env python3
"""Where the per-edge kernels' time goes, by warp role, on one NVIDIA card.

    python3 scripts/edge_kernel_roles.py [--scale 16]

``csrc/substream_match_edges.cu`` runs a walker warp (the chain of a batch),
four window-search warps and two eligibility warps per CTA, meeting at one
barrier per batch. This script builds the source as it is and four variants
with one role's loop switched off (their results are wrong on purpose and
are not checked), times each on the paper configuration at ``--scale`` in
the blocked order (CUDA events, mean of 3 after a warm-up), and prints one
line per variant and layout. A variant's drop from the full kernel bounds
what that role costs; "none" (every role's loop off) leaves the row loads,
the write-back and the barriers: the floor that prefetching one batch ahead
sets. The full kernel's ``assigned`` is held to its plain version first.
Needs a CUDA card.
"""
import argparse
import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: role -> (text in the source, its replacement): the role's loop runs no step
SWITCH_OFF = {
    "walker": ("        for (int round = 0; round <= kBatch; ++round) {",
               "        for (int round = 0; round < 0; ++round) {"),
    "search": ("      for (int s0 = s_lo; s0 < s_lo + kBatch / 2; s0 += 4) {",
               "      for (int s0 = s_lo; s0 < s_lo; s0 += 4) {"),
    "eligibility": ("      for (int j = 0; j < kBatch / 2; ++j) {\n        const int s = s_lo + j;",
                    "      for (int j = 0; j < 0; ++j) {\n        const int s = s_lo + j;"),
}
VARIANTS = {"full": [], **{f"no_{k}": [v] for k, v in SWITCH_OFF.items()},
            "none": list(SWITCH_OFF.values())}


def main():
    import torch

    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import EdgeStream, SubstreamConfig, lexicographic_order, permute_stream
    from repro_torch.graph.generators import kronecker_graph, uniform_weights
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import kernel_inputs

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("edge_kernel_roles: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    config = dataclasses.replace(CONFIG, scale=args.scale)
    src, dst = kronecker_graph(config.scale, config.edge_factor, seed=config.seed)
    w = uniform_weights(src.shape[0], config.L, config.eps, seed=config.seed)
    stream = EdgeStream.from_numpy(src, dst, w)
    cfg = SubstreamConfig(n=1 << config.scale, L=config.L, eps=config.eps)
    blocked = permute_stream(stream, lexicographic_order(stream, config.K))
    m = blocked.num_edges
    source = kernel.EDGES_SOURCE.read_text()
    out_dir = ROOT / "build" / "edge_kernel_roles"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for variant, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{variant}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = out_dir / f"edges_{variant}.cu"
        path.write_text(text)
        lib = build.load_library(f"edges_{variant}", path)
        for packed in (True, False):
            name = kernel.NAME if packed else kernel.UNPACKED_NAME
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            edges, wt, thr, n_pad, _ = kernel_inputs(blocked, cfg, packed=packed)
            width = thr.shape[1]
            mb = torch.zeros((n_pad, width), dtype=torch.uint8 if packed else torch.int8,
                             device=edges.device)
            assigned = torch.empty(m, dtype=torch.int32, device=edges.device)

            def run():
                err = fn(edges.data_ptr(), wt.data_ptr(), thr.data_ptr(), mb.data_ptr(),
                         assigned.data_ptr(), m, width, width,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{variant} {name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            if variant == "full":
                plain = kernel.substream_match_packed_plain if packed else kernel.substream_match_unpacked_plain
                head = 20_000
                a_p, _ = plain(edges[:head], wt[:head], thr, n_pad)
                mb.zero_()
                run()
                if not torch.equal(assigned[:head], a_p):
                    raise AssertionError(f"{name} differs from its plain version")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                mb.zero_()
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            rows.append({"variant": variant, "kernel": name, "ms": ms, "ns_per_edge": ms * 1e6 / m})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"scale": args.scale, "m": m, "order": "blocked", "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
