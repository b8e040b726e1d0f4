#!/usr/bin/env python3
"""Where the unpacked wave kernels' time goes, by stage, on one NVIDIA card.

    python3 scripts/wave_kernel_stages.py [--scale 20]

``csrc/substream_match_waves_unpacked.cu`` counts every slot's passing
thresholds in a pass across the card, then walks the waves in one CTA with
one barrier per wave, the slot stream staged ahead in a ring in shared
memory; on the chain of a wave sit shared-memory reads of its slot and one
round trip to its two rows in the packed working copy of the block. This script builds the source as it is
and variants made by text replacement on a copy (the source has no switch):

* ``bytes``: no working copy, rows read and written as int8 bytes in the
  block itself (a real alternative; its results are checked);
* ``no_ring``: no staging, every wave reads its slots and passing counts
  from global memory (checked);
* ``no_rows``: the row loads switched off (wrong on purpose, not checked):
  what is left is the barrier, the slot reads and the staging;
* ``threads1024`` and ``threads256``: a CTA of 1,024 or 256 threads (as
  many slots a pass at L <= 64), ``ahead4``: the slot copy four waves
  ahead instead of three (all checked).

Each runs the mega (seg_block 2) and waves kernels on the paper
configuration at ``--scale`` in its generated order (the host wave schedule
once), timed with CUDA events (mean of 3 after a warm-up), one line per
variant and kernel with ms and µs per wave. The full kernel is held to the
packed mega kernel through ``substream_match`` first. Needs a CUDA card.
"""
import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: variant -> [(text in the source, its replacement)], each text replaced everywhere
VARIANTS = {
    "full": [],
    "bytes": [
        ("  auto word_of = [&](int vertex) { return work + static_cast<size_t>(vertex) * chunks + c; };",
         "  auto word_of = [&](int vertex) {\n"
         "    return reinterpret_cast<uint8_t*>(work) + static_cast<size_t>(vertex) * width + kChunkBits * c;\n"
         "  };\n"
         "  const int pieces = min(4, max(0, (width - kChunkBits * c) / 16));"),
        ("__stcg(word_of(u), a | add);", "store_mask(word_of(u), a | add, pieces);"),
        ("__stcg(word_of(v), b | add);", "store_mask(word_of(v), b | add, pieces);"),
        ("a = __ldcg(word_of(u));", "a = load_mask(word_of(u), pieces);"),
        ("b = __ldcg(word_of(v));", "b = load_mask(word_of(v), pieces);"),
        ("  pack_block<<<grid_for(words), 256, 0, s>>>(block, copy, words, width, chunks);\n", ""),
        ("  unpack_block<<<grid_for(words), 256, 0, s>>>(copy, block, words, width, chunks);\n", ""),
        ("static_cast<const float*>(thr), copy, static_cast<int32_t*>(assigned)",
         "static_cast<const float*>(thr), reinterpret_cast<unsigned long long*>(block),\n"
         "      static_cast<int32_t*>(assigned)"),
    ],
    "no_ring": [("    if (slot_of(k + 1) <= kRingSlots) {", "    if (false) {"),
                ("const bool stage_ahead = ahead < num_waves && slot_of(ahead + 1) - lo <= kRingSlots;",
                 "const bool stage_ahead = false;")],
    "no_rows": [("a = __ldcg(word_of(u));", "a = 0;"), ("b = __ldcg(word_of(v));", "b = 0;")],
    "threads1024": [("constexpr int kThreads = 512; ", "constexpr int kThreads = 1024;")],
    "threads256": [("constexpr int kThreads = 512; ", "constexpr int kThreads = 256; ")],
    "ahead4": [("constexpr int kAhead = 3;", "constexpr int kAhead = 4;"),
               ("constexpr int kOffsetAhead = 8;", "constexpr int kOffsetAhead = 11;")],
}
CHECKED = ("full", "bytes", "no_ring", "threads1024", "threads256", "ahead4")


def variant_source(text, edits, variant):
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{variant}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def main():
    import torch

    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import EdgeStream, SubstreamConfig
    from repro_torch.core.types import to_numpy
    from repro_torch.graph import waves
    from repro_torch.graph.generators import kronecker_graph, uniform_weights
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import mega_inputs, substream_match, waves_inputs

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wave_kernel_stages: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    config = dataclasses.replace(CONFIG, scale=args.scale)
    src, dst = kronecker_graph(config.scale, config.edge_factor, seed=config.seed)
    w = uniform_weights(src.shape[0], config.L, config.eps, seed=config.seed)
    stream = EdgeStream.from_numpy(src, dst, w)
    cfg = SubstreamConfig(n=1 << config.scale, L=config.L, eps=config.eps)
    sch = waves.wave_schedule(*(to_numpy(t) for t in (stream.src, stream.dst)),
                              valid=to_numpy(stream.valid))
    m = stream.num_edges
    want = substream_match(stream, cfg, schedule="mega", waves=sch, packed=True)
    operands = {kernel.MEGA_UNPACKED_NAME: mega_inputs(stream, cfg, sch, 2, packed=False),
                kernel.WAVES_UNPACKED_NAME: waves_inputs(stream, cfg, sch, packed=False)}
    source = kernel.WAVES_UNPACKED_SOURCE.read_text()
    out_dir = ROOT / "build" / "wave_kernel_stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    for variant, edits in VARIANTS.items():
        path = out_dir / f"waves_unpacked_{variant}.cu"
        path.write_text(variant_source(source, edits, variant))
        lib = build.load_library(f"waves_unpacked_{variant}", path)
        info = build.builds[f"waves_unpacked_{variant}"]
        regs = {"seconds": info["seconds"],
                "registers": [int(r) for r in re.findall(r"Used (\d+) registers", info["ptxas"])],
                "spills": re.findall(r"(\d+) bytes spill stores", info["ptxas"])}
        for name, (ops, slots) in operands.items():
            mega = name == kernel.MEGA_UNPACKED_NAME
            fn = getattr(lib, name)
            ints = [ctypes.c_int] * (3 if mega else 2)
            fn.argtypes = [ctypes.c_void_p, *ints, *[ctypes.c_void_p] * 7, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            ids, wt, thr, offs, n_pad, seg = ops[:6]
            extra = (seg * ops[6],) if mega else ()
            width = thr.shape[-1]
            rows = n_pad + kernel.SACRIFICIAL_ROWS
            mb = torch.zeros((rows, width), dtype=torch.int8, device=ids.device)
            work = torch.empty((rows, -(-width // kernel.WAVE_CHUNK_BITS)), dtype=torch.int64,
                               device=ids.device)
            assigned = torch.empty(wt.shape[0], dtype=torch.int32, device=ids.device)
            counts = torch.empty(wt.shape[0], dtype=torch.int32, device=ids.device)

            def run():
                mb.zero_()
                assigned.fill_(-1)
                err = fn(offs.data_ptr(), offs.shape[0] - 1, seg, *extra, ids.data_ptr(),
                         wt.data_ptr(), thr.data_ptr(), mb.data_ptr(), work.data_ptr(),
                         counts.data_ptr(), assigned.data_ptr(), wt.shape[0], rows, width,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{variant} {name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            if variant in CHECKED:
                got = waves.scatter_slot_assignments(slots, assigned, m)
                if not (torch.equal(got, want.assigned)
                        and torch.equal(mb[: cfg.n, : cfg.L].ne(0), want.mb)):
                    raise AssertionError(f"{variant} {name} differs from the packed mega kernel")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            print(json.dumps({"variant": variant, "kernel": name, "ms": ms,
                              "us_per_wave": ms * 1e3 / sch.num_waves,
                              "checked": variant in CHECKED, "build": regs}), flush=True)
    sizes = sch.wave_sizes()
    print(json.dumps({"scale": args.scale, "m": m, "order": "generated", "waves": sch.num_waves,
                      "max_wave": int(sizes.max()), "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
