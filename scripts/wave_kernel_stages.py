#!/usr/bin/env python3
"""Where the wave kernels' time goes, by stage, on one NVIDIA card.

    python3 scripts/wave_kernel_stages.py [--scale 20]

``csrc/substream_match_waves.cu`` holds the four wave kernels (mega and
waves, packed and unpacked) over one walk: every slot's passing thresholds
counted in a pass across the card, then one CTA walks the waves with one
barrier per wave, the slot stream staged ahead in a ring in shared memory;
on the chain of a wave sit shared-memory reads of its slot and one round
trip to its two rows, 64-bit words of the packed block itself or of the
unpacked block's packed working copy. This script builds the source as it
is and variants made by text replacement on a copy (the source has no
switch):

* ``bytes``: no working copy, rows read and written as int8 bytes in the
  unpacked block itself (a real alternative for the unpacked kernels only;
  its results are checked);
* ``no_ring``: no staging, every wave reads its slots and passing counts
  from global memory (checked);
* ``no_rows``: the row loads switched off (wrong on purpose, not checked):
  what is left is the barrier, the slot reads and the staging;
* ``threads1024`` and ``threads256``: a CTA of 1,024 or 256 threads (as
  many slots a pass at L <= 64), ``ahead4``: the slot copy four waves
  ahead instead of three (all checked);
* ``stamps``: ``clock64()`` written at the walk's stage boundaries for
  ``STAMP_WAVES`` waves spread over the whole order (every stride-th one;
  checked), by thread 0 (the first slot of each wave) and by the first
  thread of each staging warp, with the wave's slots and whether they were
  staged. Its line gives the median SM cycles per wave of each stage: the
  slot read after the barrier, the row loads, the stores and the shuffle,
  the rest of the wave's passes, the barrier (from thread 0 reaching it to
  the next wave's start), and the staging warps' copies and plan; over all
  stamped waves, over the staged waves of one pass, and over the others.

Each runs the four kernels (mega at seg_block 2) on the paper configuration
at ``--scale`` in its generated order (the host wave schedule once), timed
with CUDA events (mean of 3 after a warm-up), one line per variant and
kernel with ms and µs per wave. Checked variants are held, scattered to the
stream, to the packed per-edge kernel on the same order. Needs a CUDA card.
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

#: waves whose stage boundaries the ``stamps`` variant records (every STRIDE-th wave, STRIDE
#: set from the schedule so that they span the whole order), and the stamps a wave
STAMP_WAVES = 4096
STAMP_COLS = 14
#: stamp column -> what was reached (t0: thread 0; s0, s32: the first thread of each staging
#: warp; next: thread 0 at the start of the next wave), then the wave's slots and whether its
#: slots were staged in the ring
STAMPS = ("t0_start", "t0_slot_read", "t0_rows_loaded", "t0_stored", "t0_at_barrier",
          "s0_start", "s0_issued", "s0_end", "s32_issued", "s32_end", "next_start",
          "slots", "staged", "passes")
STRIDE = "kStampStride"


def _stamp(col, cond="tid == 0 && base == 0", uses=""):
    keep = f'asm volatile("" :: {uses}); ' if uses else ""
    return f"if (stamp && {cond}) {{ {keep}g_stamps[row][{col}] = clock64(); }}\n"


#: variant -> [(text in the source, its replacement)], each text replaced everywhere
VARIANTS = {
    "full": [],
    "bytes": [
        ("  auto word_of = [&](int vertex) { return work + static_cast<size_t>(vertex) * chunks + c; };",
         "  auto word_of = [&](int vertex) {\n"
         "    return reinterpret_cast<uint8_t*>(work) + static_cast<size_t>(vertex) * lanes + kChunkBits * c;\n"
         "  };\n"
         "  const int pieces = min(4, max(0, (lanes - kChunkBits * c) / 16));"),
        ("__stcg(word_of(u), a | add);", "store_mask(word_of(u), a | add, pieces);"),
        ("__stcg(word_of(v), b | add);", "store_mask(word_of(v), b | add, pieces);"),
        ("a = __ldcg(word_of(u));", "a = load_mask(word_of(u), pieces);"),
        ("b = __ldcg(word_of(v));", "b = load_mask(word_of(v), pieces);"),
        ("  if constexpr (!kPacked)\n"
         "    pack_block<<<grid_for(words), 256, 0, s>>>(block, copy, words, width, chunks);\n", ""),
        ("  if constexpr (!kPacked)\n"
         "    unpack_block<<<grid_for(words), 256, 0, s>>>(copy, block, words, width, chunks);\n", ""),
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
    "stamps": [
        ("constexpr unsigned kFull = 0xffffffffu;\n",
         "constexpr unsigned kFull = 0xffffffffu;\n"
         f"__device__ long long g_stamps[{STAMP_WAVES}][{STAMP_COLS}];\n"),
        ("constexpr int kThreads = 512; ", f"constexpr int {STRIDE} = STRIDE_VALUE;\n"
         "constexpr int kThreads = 512; "),
        ("    const int n = static_cast<int>(hi - lo);\n",
         f"    const int row = k / {STRIDE};\n"
         f"    const bool stamp = k % {STRIDE} == 0 && row < {STAMP_WAVES};\n"
         f"    if (tid == 0 && k > 0 && (k - 1) % {STRIDE} == 0 && (k - 1) / {STRIDE} < {STAMP_WAVES})\n"
         f"      g_stamps[(k - 1) / {STRIDE}][10] = clock64();\n"
         "    " + _stamp(0, "tid == 0") + "    " + _stamp(5, "stager == 0")
         + "    const int n = static_cast<int>(hi - lo);\n"
         "    if (stamp && tid == 0) {\n"
         "      g_stamps[row][11] = n;\n"
         "      g_stamps[row][12] = pipe & 1;\n"
         "      g_stamps[row][13] = (n + P - 1) / P;\n"
         "    }\n"),
        ("      cp_async_commit();\n      const int next = ahead + 1;\n",
         "      cp_async_commit();\n"
         "      " + _stamp(6, "stager == 0") + "      " + _stamp(8, "stager == 32")
         + "      const int next = ahead + 1;\n"),
        ("        plan_hi = slot_of(next + 1);\n      }\n",
         "        plan_hi = slot_of(next + 1);\n      }\n"
         "      " + _stamp(7, "stager == 0", '"l"(plan_lo), "l"(plan_hi)')
         + "      " + _stamp(9, "stager == 32", '"l"(plan_lo), "l"(plan_hi)')),
        ("      // Both rows' words are loaded before either is stored.\n",
         "      " + _stamp(1, uses='"l"(te), "r"(u), "r"(v)')
         + "      // Both rows' words are loaded before either is stored.\n"),
        ("      const unsigned long long add = te & ~(a | b);\n",
         "      const unsigned long long add = te & ~(a | b);\n"
         "      " + _stamp(2, uses='"l"(a), "l"(b)')),
        ("      if (c == 0 && r < n) assigned[s] = best;\n",
         "      if (c == 0 && r < n) assigned[s] = best;\n"
         "      " + _stamp(3, uses='"r"(best)')),
        ("    if (stager >= 0) cp_async_wait<kWait>();",
         "    " + _stamp(4, "tid == 0") + "    if (stager >= 0) cp_async_wait<kWait>();"),
        ("}  // namespace\n",
         "}  // namespace\n\n"
         'extern "C" int read_stamps(void* dst) {\n'
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)));\n"
         "}\n"),
    ],
}
UNCHECKED = ("no_rows",)


def variant_source(text, edits, variant):
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{variant}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def stage_split(stamps):
    """Median SM cycles of each stage of the stamped waves (int64 [n, STAMP_COLS]
    rows, one a wave), and how many waves that is."""
    import numpy as np

    t = {name: stamps[:, i] for i, name in enumerate(STAMPS)}
    spans = {
        "slot_read": t["t0_slot_read"] - t["t0_start"],
        "rows_loaded": t["t0_rows_loaded"] - t["t0_slot_read"],
        "stores_and_shuffle": t["t0_stored"] - t["t0_rows_loaded"],
        "other_passes": t["t0_at_barrier"] - t["t0_stored"],
        "barrier": t["next_start"] - t["t0_at_barrier"],
        "wave": t["next_start"] - t["t0_start"],
        "stager_ids_issued": t["s0_issued"] - t["s0_start"],
        "stager_ids_end": t["s0_end"] - t["s0_start"],
        "stager_vals_issued": t["s32_issued"] - t["s0_start"],
        "stager_vals_end": t["s32_end"] - t["s0_start"],
        "stager_start_after_t0": t["s0_start"] - t["t0_start"],
    }
    out = {k: float(np.median(v)) for k, v in spans.items()}
    out.update(waves=int(stamps.shape[0]), median_slots=float(np.median(t["slots"])))
    return out


def main():
    import numpy as np
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
    want = substream_match(stream, cfg, packed=True)  # the per-edge kernel, on the same order
    operands = {}
    for packed in (True, False):
        names = (kernel.MEGA_NAME, kernel.WAVES_NAME) if packed else (
            kernel.MEGA_UNPACKED_NAME, kernel.WAVES_UNPACKED_NAME)
        operands[names[0]] = (mega_inputs(stream, cfg, sch, 2, packed=packed), packed)
        operands[names[1]] = (waves_inputs(stream, cfg, sch, packed=packed), packed)
    source = kernel.WAVES_SOURCE.read_text()
    stride = max(1, -(-sch.num_waves // STAMP_WAVES))
    stamped = np.arange(0, sch.num_waves - 1, stride)[:STAMP_WAVES]  # each has a next wave
    out_dir = ROOT / "build" / "wave_kernel_stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    for variant, edits in VARIANTS.items():
        path = out_dir / f"waves_{variant}.cu"
        path.write_text(variant_source(source, edits, variant).replace("STRIDE_VALUE", str(stride)))
        lib = build.load_library(f"waves_{variant}", path)
        info = build.builds[f"waves_{variant}"]
        regs = {"seconds": info["seconds"],
                "registers": [int(r) for r in re.findall(r"Used (\d+) registers", info["ptxas"])],
                "spills": re.findall(r"(\d+) bytes spill stores", info["ptxas"])}
        for name, ((ops, slots), packed) in operands.items():
            if variant == "bytes" and packed:
                continue  # the packed block already is the words the walk reads
            mega = name in (kernel.MEGA_NAME, kernel.MEGA_UNPACKED_NAME)
            fn = getattr(lib, name)
            ints = [ctypes.c_int] * (3 if mega else 2)
            fn.argtypes = [ctypes.c_void_p, *ints, *[ctypes.c_void_p] * (6 if packed else 7),
                           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            ids, wt, thr, offs, n_pad, seg = ops[:6]
            extra = (seg * ops[6],) if mega else ()
            lanes = thr.t().contiguous()  # bit planes [8, width] -> lane 8k+j, as the wrapper
            width = lanes.numel() // 8 if packed else lanes.numel()
            rows = n_pad + kernel.SACRIFICIAL_ROWS
            mb = torch.zeros((rows, width), dtype=torch.uint8 if packed else torch.int8,
                             device=ids.device)
            work = [] if packed else [torch.empty((rows, -(-width // kernel.WAVE_CHUNK_BITS)),
                                                  dtype=torch.int64, device=ids.device)]
            assigned = torch.empty(wt.shape[0], dtype=torch.int32, device=ids.device)
            counts = torch.empty(wt.shape[0], dtype=torch.int32, device=ids.device)

            def run():
                mb.zero_()
                assigned.fill_(-1)
                err = fn(offs.data_ptr(), offs.shape[0] - 1, seg, *extra, ids.data_ptr(),
                         wt.data_ptr(), lanes.data_ptr(), mb.data_ptr(),
                         *(t.data_ptr() for t in work), counts.data_ptr(), assigned.data_ptr(),
                         wt.shape[0], rows, width, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{variant} {name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            line = {"variant": variant, "kernel": name, "checked": variant not in UNCHECKED}
            if variant == "stamps":
                stamps = np.zeros((STAMP_WAVES, STAMP_COLS), np.int64)
                err = lib.read_stamps(ctypes.c_void_p(stamps.ctypes.data))
                if err:
                    raise RuntimeError(f"read_stamps: CUDA error {err}")
                sampled = stamps[: stamped.size]
                one = ((sampled[:, STAMPS.index("staged")] == 1)
                       & (sampled[:, STAMPS.index("passes")] == 1))
                line.update(stride=stride, median_cycles=stage_split(sampled),
                            staged_one_pass=stage_split(sampled[one]),
                            other=stage_split(sampled[~one]) if (~one).any() else None)
            if line["checked"]:
                got = waves.scatter_slot_assignments(slots, assigned, m)
                bits = (mb[: cfg.n].view(torch.uint8) if packed
                        else mb[: cfg.n, : cfg.L].ne(0))
                want_bits = want.mb_packed if packed else want.mb
                if not (torch.equal(got, want.assigned)
                        and torch.equal(bits[:, : want_bits.shape[1]], want_bits)):
                    raise AssertionError(f"{variant} {name} differs from the per-edge kernel")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            line.update(ms=ms, us_per_wave=ms * 1e3 / sch.num_waves, build=regs)
            print(json.dumps(line), flush=True)
    sizes = sch.wave_sizes()
    print(json.dumps({"scale": args.scale, "m": m, "order": "generated", "waves": sch.num_waves,
                      "max_wave": int(sizes.max()), "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
