#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in the checkout
(one nvcc per source, all at once), holds each of the six against its
plain PyTorch version on the card, then drives these paths of the paper's
configuration (Kronecker scale 20, edge factor 48, L=64, eps=0.1, K=32):

* the main path: blocked order -> packed per-edge kernel -> greedy merge,
  through ``mwm_pipeline(part1="kernel")``;
* the wave path: the stream in its generated order -> host wave schedule
  -> ``substream_match(schedule="mega")`` and ``schedule="waves"``, held
  bit for bit against the per-edge kernel on the same order, merged and
  checked;
* the unpacked main path, ``mwm_pipeline(part1="kernel", packed=False)``
  (the int8 block, one byte per substream), and the unpacked wave path on
  the wave path's schedule, each bit-equal to its packed twin; the four
  wave kernels (one walk) also on streams aimed at their slot ring (a wave
  of 5,000 edges, a star of 3,000 leaves, mixed widths; L 64, 300 and
  2048; carried blocks, unpacked with bytes of 5, packed with bits past L;
  thresholds in any order; misaligned operands), held to their plain
  versions and to the packed per-edge kernel on the same stream order;
* the epoch path: ``match_epochs`` (4 epochs, and resumed from the state
  after epoch 2) equal to its one-shot run, on the blocked paper stream
  through the unpacked per-edge kernel, and at scale 16 through the wave
  kernels in both layouts;
* the blocked order through the wave kernels at scale 16;
* the robustness and observability layers: ``merge_device`` (Part 2 on the
  card, through the packed per-edge kernel at L = 1) against
  ``merge_host``; the main path with an enabled ``Telemetry``;
  ``validate_stream`` in strict and sanitize modes on the paper stream,
  clean and poisoned; the fallback ladder at scale 16 (its kernel rungs,
  the only ones on the card), clean and with each rung refused in turn,
  both layouts, and at L = 2049; the epoch path with a snapshot per epoch, killed after epoch 2
  and resumed from disk with one transient flake retried by the
  ``ExecutionGuard``;
* the parallel-rounds engine: ``mwm_rounds`` at the paper config in the
  generated order, bit-equal to the packed per-edge kernel on that order
  (rounds, seconds, peak memory), ``mwm_pipeline(part1="rounds")`` beside
  ``part1="kernel"``, and the blocked order (at full width if its rounds
  fit in ROUNDS_BLOCKED_BUDGET_S, else at scale 16, saying why);
  ``mwm_rounds_sharded`` on a 1x1 NCCL mesh at scale 16, equal to
  ``mwm_rounds``;
* the graph substrate: ``coarsen_by_matching`` on the paper stream
  (through the packed per-edge kernel, counted) and at scale 12 equal to
  the CPU run, ``gseq`` on a 20,000-edge prefix and the segment ops at
  scale 16, card against CPU; the main path on the flickr standin
  (``real_graph_standin``: n = 2^22, about 33 M edges), checked.

Each path runs with the launch counts set to 0 just before it and read
just after. Each phase prints one JSON line; any failure raises, so the
script exits non-zero. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.
"""
import concurrent.futures
import contextlib
import functools
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: edges of the blocked paper stream on which the per-edge kernel meets its plain version
PLAIN_PREFIX = 20_000
#: edges of the generated paper stream on which the wave kernels meet theirs
WAVE_PLAIN_PREFIX = 200_000
#: the scale of the blocked-order route through the wave kernels
BLOCKED_WAVE_SCALE = 16
#: the longest the rounds may take on the blocked paper stream before that order
#: is run at ROUNDS_BLOCKED_FALLBACK_SCALE instead
ROUNDS_BLOCKED_BUDGET_S = 60.0
ROUNDS_BLOCKED_FALLBACK_SCALE = 16
#: the rounds' peak device memory at the paper config must stay under this
ROUNDS_PEAK_LIMIT = 40e9
#: the scale of the 1x1 NCCL mesh's stream and of the segment ops' graph
SHARDED_SCALE = 16
SEGMENT_SCALE = 16
#: the coarsening's card-against-CPU check, and G-SEQ's prefix
COARSEN_CHECK_SCALE = 12
GSEQ_PREFIX = 20_000
#: the segment ops on the card against the CPU: a sum's error over its terms' absolute sum
SEGMENT_RTOL = 1e-5
#: the paper dataset whose standin runs the main path
REAL_GRAPH = "flickr"


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps=1):
    """Mean milliseconds of ``fn()`` on the card (CUDA events), and its result."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(m, n_pad, width, packed=True):
    """(bound_ms, bound_by) of Part 1 on m edges from zero bits: each input
    read once and each output written once (edge pair, weight, assigned,
    the bit block of n_pad rows of width bytes), or the float32 threshold
    compares (8 per packed byte, 1 per unpacked byte)."""
    nbytes = m * 16 + n_pad * width
    ops = m * (8 if packed else 1) * width
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_share(edges):
    """Shares of the edges (int32 [m, 2] on the card) that the per-edge
    kernels forward to: an endpoint that an earlier edge of the window
    touched (the previous batch or the earlier lanes of its own), and the
    part of those whose toucher is in the edge's own batch."""
    import torch

    from repro_torch.kernels.substream_match import kernel

    m, batch = edges.shape[0], kernel.EDGE_BATCH
    if m == 0:
        return {"window": 0.0, "own_batch": 0.0}
    vert = edges.reshape(-1)
    pos = torch.arange(2 * m, device=edges.device) // 2
    order = torch.argsort(vert, stable=True)
    v_s, p_s = vert[order], pos[order]
    prev = torch.full_like(p_s, -1)
    prev[1:] = torch.where(v_s[1:] == v_s[:-1], p_s[:-1], -1)
    hit = (prev >= 0) & (prev < p_s)  # a self-loop's second endpoint is not its own toucher
    start = (p_s // batch) * batch
    shares = {}
    for key, lo in (("window", (start - batch).clamp_min(0)), ("own_batch", start)):
        per_edge = torch.zeros(m, dtype=torch.int32, device=edges.device)
        per_edge.index_add_(0, p_s, (hit & (prev >= lo)).to(torch.int32))
        shares[key] = float((per_edge > 0).float().mean())
    return shares


def wave_widths(sch):
    """The schedule's waves by width in slots: the share of the waves and of
    the scheduled edges in waves of <= 32, <= 128, <= 1024 and > 1024 slots,
    and the widest wave."""
    import numpy as np

    slots = np.diff(sch.seg_offsets).astype(np.int64) * sch.width
    edges = sch.wave_sizes().astype(np.int64)
    out = {}
    for label, lo, hi in (("<=32", 0, 32), ("<=128", 33, 128), ("<=1024", 129, 1024),
                          (">1024", 1025, None)):
        pick = (slots >= lo) & (slots <= hi if hi else True)
        out[label] = {"waves": float(pick.mean()) if slots.size else 0.0,
                      "edges": float(edges[pick].sum() / max(edges.sum(), 1))}
    out["max_wave_slots"] = int(slots.max()) if slots.size else 0
    return out


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit("device", **device, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return device, smi


def _ptxas_entries(ptxas):
    """{entry function: {"registers", "spill_bytes"}} from nvcc's -Xptxas -v."""
    out = {}
    for name, body in re.findall(r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|$)",
                                 ptxas, re.S):
        regs = re.findall(r"Used (\d+) registers", body)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        out[name] = {"registers": int(regs[0]) if regs else None,
                     "spill_bytes": sum(int(a) + int(b) for a, b in spills)}
    return out


def phase_build():
    """Build every source at once, one nvcc each."""
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel

    loads = {kernel.EDGES_LIBRARY: kernel._launcher,
             kernel.WAVES_LIBRARY: lambda: kernel._waves_launcher(kernel.MEGA_NAME)}
    sources = {kernel.EDGES_LIBRARY: kernel.EDGES_SOURCE, kernel.WAVES_LIBRARY: kernel.WAVES_SOURCE}
    with concurrent.futures.ThreadPoolExecutor(len(loads)) as pool:
        for fut in [pool.submit(fn) for fn in loads.values()]:
            fut.result()
    for name in loads:
        info = build.builds[name]
        entries = _ptxas_entries(info["ptxas"])
        emit("build", library=name, source=sources[name].name, seconds=info["seconds"],
             built=info["built"], entries=entries)
        if not info["built"] or not entries:
            raise RuntimeError(f"{name} was not built from the checkout's source")
        spilled = {k: v for k, v in entries.items() if v["spill_bytes"]}
        if spilled:
            raise RuntimeError(f"{name} spills registers: {spilled}")


def paper_stream(config=None):
    """The paper's configuration (or ``config``), generated on the host in
    its generated order and moved to the card."""
    import torch

    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import EdgeStream, SubstreamConfig
    from repro_torch.graph.generators import kronecker_graph, uniform_weights

    config = config or CONFIG
    t0 = time.perf_counter()
    src, dst = kronecker_graph(config.scale, config.edge_factor, seed=config.seed)
    w = uniform_weights(src.shape[0], config.L, config.eps, seed=config.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = EdgeStream.from_numpy(src, dst, w)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    cfg = SubstreamConfig(n=1 << config.scale, L=config.L, eps=config.eps)
    return config, stream, cfg, gen_s, h2d_s


def _on_card(case, mb0=None):
    """A case of :mod:`repro_torch.testing.cases` on the card, its config and ``mb0``."""
    from repro_torch.core import EdgeStream, SubstreamConfig

    stream = EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad)
    return stream, SubstreamConfig(n=case.n, L=case.L, eps=case.eps), mb0


def _head(stream, lo, hi):
    """Edges ``[lo, hi)`` of ``stream``."""
    import torch

    from repro_torch.core import permute_stream

    return permute_stream(stream, torch.arange(lo, hi, device=stream.device))


def _window_cases():
    """The streams aimed at the per-edge kernels' batch window
    (:data:`repro_torch.testing.cases.WINDOW`) at L = 64, the hub and the
    pairs 33 edges apart at L = 2048 (32 column chunks), and every window
    stream at L = 1, with its weights and with all weights 1."""
    import numpy as np

    from repro_torch.testing.cases import WINDOW

    cases = {f"window_{name}": _on_card(fn()) for name, fn in WINDOW.items()}
    for name in ("hub", "repeat_d33"):
        cases[f"window_{name}_L2048"] = _on_card(WINDOW[name](2048))
    for name, fn in WINDOW.items():  # one substream: merge_device's shape (weights 1)
        cases[f"window_{name}_L1"] = _on_card(fn(1))
        cases[f"window_{name}_L1_ones"] = _on_card(fn(1)._replace(w=np.ones(fn(1).w.shape, np.float32)))
    return cases


def phase_kernel_vs_plain(paper, paper_cfg, K):
    """Every case through the kernel and its plain version on the same
    operands on the card; assigned and the bit block must be equal: the
    zoo, the window cases, RMAT at L 13, 64, 300 and 2048, carried bits
    (also at L 2048), and the blocked paper prefix."""
    import torch

    from repro_torch.core import lexicographic_order, permute_stream
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import kernel_inputs, substream_match
    from repro_torch.testing.cases import WINDOW, ZOO, rmat_case

    cases = {f"zoo_{name}": _on_card(fn()) for name, fn in ZOO.items()}
    cases.update(_window_cases())
    for L, eps in ((13, 0.1), (64, 0.1), (300, 0.01)):
        cases[f"rmat12_L{L}"] = _on_card(rmat_case(12, edge_factor=4, L=L, eps=eps, pad=5))
    cases["rmat10_L2048"] = _on_card(rmat_case(10, edge_factor=4, L=2048, eps=0.002, pad=5))
    # carried state: the second half of a stream, seeded with the first half's bits
    for label, case in (("rmat12_L64", rmat_case(12, edge_factor=4, L=64)),
                        ("rmat10_L2048", rmat_case(10, edge_factor=4, L=2048, eps=0.002)),
                        ("window_hub_L2048", WINDOW["hub"](2048))):
        stream, cfg, _ = _on_card(case)
        h = stream.num_edges // 2
        mb0 = substream_match(_head(stream, 0, h), cfg).mb_packed
        cases[f"{label}_mb0"] = (_head(stream, h, stream.num_edges), cfg, mb0)
    blocked = permute_stream(paper, lexicographic_order(paper, K))
    cases["paper_blocked_prefix"] = (_head(blocked, 0, PLAIN_PREFIX), paper_cfg, None)

    results, max_err, timed = {}, 0, {}
    for name, (stream, cfg, mb0) in cases.items():
        args = kernel_inputs(stream, cfg, mb0)
        a_k, mb_k = kernel.substream_match_packed(*args)
        t0 = time.perf_counter()
        a_p, mb_p = kernel.substream_match_packed_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max(int((a_k - a_p).abs().max()) if a_k.numel() else 0,
                  int((mb_k.int() - mb_p.int()).abs().max()))
        max_err = max(max_err, err)
        results[name] = {"m": stream.num_edges, "L": cfg.L, "equal": err == 0}
        if name == "paper_blocked_prefix":
            ms, _ = cuda_ms(lambda: kernel.substream_match_packed(*args), reps=5)
            timed = {"plain_ms": plain_s * 1e3, "ms_at_plain_m": ms,
                     "bound_ms_at_plain_m": bound(stream.num_edges, args[3], args[2].shape[1])[0]}
    emit("kernel_vs_plain", kernel=kernel.NAME, cases=results, max_abs_err=max_err, **timed)
    bad = [k for k, v in results.items() if not v["equal"]]
    if bad:
        raise AssertionError(f"kernel differs from its plain version on {bad}")
    return max_err, timed


def _compare(a_k, mb_k, a_p, mb_p):
    """max |kernel - plain| over assigned and the bit block (0 = equal)."""
    return max(int((a_k - a_p).abs().max()) if a_k.numel() else 0,
               int((mb_k.int() - mb_p.int()).abs().max()) if mb_k.numel() else 0)


def phase_wave_kernels_vs_plain(paper, paper_cfg):
    """Both packed wave kernels and their plain versions on the same
    operands on the card: the zoo, RMAT scale 12 at three L, a carried-state
    run, seg_block 1, 2 and 4 for mega, and a prefix of the paper stream in
    its generated order; then the ring cases (:func:`_ring_checks`).
    Returns {kernel: (max_abs_err, timings at the prefix)}."""
    import torch

    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import (
        MEGA_SEG_BLOCK, mega_inputs, resolve_stream_schedule, substream_match, waves_inputs,
    )
    from repro_torch.testing.cases import ZOO, rmat_case

    cases = {f"zoo_{name}": _on_card(fn()) for name, fn in ZOO.items()}
    for L, eps in ((13, 0.1), (64, 0.1), (300, 0.01)):
        cases[f"rmat12_L{L}"] = _on_card(rmat_case(12, edge_factor=4, L=L, eps=eps, pad=5))
    stream, cfg, _ = _on_card(rmat_case(12, edge_factor=4, L=64))
    h = stream.num_edges // 2
    mb0 = substream_match(_head(stream, 0, h), cfg, schedule="mega").mb_packed
    cases["rmat12_L64_mb0"] = (_head(stream, h, stream.num_edges), cfg, mb0)
    cases["paper_generated_prefix"] = (_head(paper, 0, WAVE_PLAIN_PREFIX), paper_cfg, None)

    engines = {kernel.MEGA_NAME: (kernel.substream_match_mega, kernel.substream_match_mega_plain),
               kernel.WAVES_NAME: (kernel.substream_match_waves, kernel.substream_match_waves_plain)}
    results = {name: {} for name in engines}
    max_err = dict.fromkeys(engines, 0)
    timed = {}
    for case, (stream, cfg, mb0) in cases.items():
        sch = resolve_stream_schedule(stream)
        prefix = case == "paper_generated_prefix"
        variants = [(kernel.MEGA_NAME, sb, mega_inputs(stream, cfg, sch, sb, mb0)[0])
                    for sb in ((MEGA_SEG_BLOCK,) if prefix else (1, 2, 4))]
        variants.append((kernel.WAVES_NAME, None, waves_inputs(stream, cfg, sch, mb0)[0]))
        for name, sb, args in variants:
            launch, plain = engines[name]
            a_k, mb_k = launch(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a_p, mb_p = plain(*args)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = _compare(a_k, mb_k, a_p, mb_p)
            max_err[name] = max(max_err[name], err)
            label = case if sb is None else f"{case}_sb{sb}"
            results[name][label] = {"m": stream.num_edges, "L": cfg.L, "waves": sch.num_waves,
                                    "equal": err == 0}
            if prefix:
                ms, _ = cuda_ms(lambda: launch(*args), reps=5)
                plan_n_pad, width = args[4], (args[2].shape[-1] if name == kernel.WAVES_NAME
                                              else args[2].shape[0] // 8)
                timed[name] = {"plain_ms": plain_s * 1e3, "ms_at_plain_m": ms,
                               "bound_ms_at_plain_m": bound(stream.num_edges, plan_n_pad, width)[0]}
    _ring_checks(results, max_err, *cases["rmat12_L64"][:2], packed=True)
    for name in engines:
        emit("kernel_vs_plain", kernel=name, cases=results[name], max_abs_err=max_err[name],
             plain_m=WAVE_PLAIN_PREFIX, **timed[name])
        bad = [k for k, v in results[name].items()
               if not (v["equal"] and v.get("equal_edges_kernel", True))]
        if bad:
            raise AssertionError(f"{name} differs from its plain version on {bad}")
    return {name: (max_err[name], timed[name]) for name in engines}


def phase_main_path(config, stream, cfg, gen_s, h2d_s):
    """The main path once through the public entry point, counted; then the
    same calls stage by stage, timed, and the result checked."""
    import torch

    from repro_torch.core import (
        MatchingResult, check_matching, lexicographic_order, merge_host, mwm_pipeline,
        permute_stream,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import device_plan, kernel_inputs

    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=config.K)
    pipeline_s = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches.get(kernel.NAME, 0) < 1:
        raise AssertionError(f"the main path launched no {kernel.NAME}: {launches}")

    def sort():
        order = lexicographic_order(stream, config.K)
        return order, permute_stream(stream, order)

    sort_ms, (order, blocked) = cuda_ms(sort)
    args = kernel_inputs(blocked, cfg)
    shares = window_share(args[0])
    kernel_runs = []
    for _ in range(3):
        ms, (a_blk, mb) = cuda_ms(lambda: kernel.substream_match_packed(*args))
        kernel_runs.append(ms)
    kernel_ms = sorted(kernel_runs)[1]
    plan = device_plan(cfg.n, cfg.L)
    assigned = torch.empty_like(a_blk)
    assigned[order] = a_blk
    result = MatchingResult(assigned, mb_packed=mb[: cfg.n, : plan.words], L=cfg.L)
    t0 = time.perf_counter()
    merged = merge_host(stream, result, cfg)
    merge_s = time.perf_counter() - t0
    if not (merged.shape == idx.shape and (merged == idx).all()):
        raise AssertionError("the staged run disagrees with mwm_pipeline")
    t0 = time.perf_counter()
    check_matching(result, stream, cfg, merged=idx)
    check_s = time.perf_counter() - t0
    m = stream.num_edges
    recorded = int((assigned >= 0).sum())
    if not (0 < idx.size <= recorded) or not weight > 0:
        raise AssertionError(f"implausible matching: {idx.size} edges, weight {weight}")
    bound_ms, bound_by = bound(m, plan.n_pad, plan.width)
    emit("main_path", config=config.name, scale=config.scale, edge_factor=config.edge_factor,
         L=cfg.L, eps=cfg.eps, K=config.K, n=cfg.n, m=m,
         bit_block_bytes=plan.nbytes, fits_l2=plan.fits_l2,
         seconds={"generate_host": gen_s, "from_numpy_h2d": h2d_s, "pipeline": pipeline_s,
                  "sort_permute": sort_ms / 1e3, "kernel": kernel_ms / 1e3,
                  "kernel_runs": [t / 1e3 for t in kernel_runs],
                  "merge_host": merge_s, "check_matching": check_s},
         edges_per_s_pipeline=m / pipeline_s, edges_per_s_part1_kernel=m / (kernel_ms / 1e3),
         ns_per_edge_kernel=kernel_ms * 1e6 / m, window_share=shares,
         launches=launches, max_memory_allocated=peak,
         recorded_edges=recorded, matched_edges=int(idx.size), weight=weight,
         check_matching="passed")
    return {"m": m, "ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": launches[kernel.NAME], "result": result, "idx": idx, "weight": weight,
            "pipeline_s": pipeline_s, "merge_host_s": merge_s}


def phase_wave_path(config, stream, cfg):
    """The wave path at full size, in the stream's generated order: the host
    schedule once, then ``substream_match(schedule="mega")`` and
    ``schedule="waves"`` through the public entry point, each counted
    alone; then the same calls stage by stage, timed; the per-edge kernel
    on the same order once; all three bit-equal; the merge checked."""
    import numpy as np
    import torch

    from repro_torch.core import check_matching, merge_host
    from repro_torch.core.types import to_numpy
    from repro_torch.graph import waves
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import (
        device_plan, kernel_inputs, mega_inputs, substream_match, waves_inputs,
    )

    src, dst, valid = (to_numpy(t) for t in (stream.src, stream.dst, stream.valid))
    t0 = time.perf_counter()
    sch = waves.wave_schedule(src, dst, valid=valid)
    schedule_s = time.perf_counter() - t0
    sizes = sch.wave_sizes()
    m = stream.num_edges
    plan = device_plan(cfg.n, cfg.L)
    engines = {"mega": (kernel.MEGA_NAME, kernel.substream_match_mega, mega_inputs),
               "waves": (kernel.WAVES_NAME, kernel.substream_match_waves, waves_inputs)}
    results, report = {}, {}
    for schedule, (name, launch, inputs) in engines.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launches.clear()
        t0 = time.perf_counter()
        res = substream_match(stream, cfg, schedule=schedule, waves=sch)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = dict(build.launches)
        peak = torch.cuda.max_memory_allocated()
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the wave path launched no {name}: {launches}")
        results[schedule] = res
        t0 = time.perf_counter()
        args, slots = inputs(stream, cfg, sch)
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t0
        runs = []
        for _ in range(3):
            ms, (a_slots, mb) = cuda_ms(lambda: launch(*args))
            runs.append(ms)
        t0 = time.perf_counter()
        assigned = waves.scatter_slot_assignments(slots, a_slots, m)
        torch.cuda.synchronize()
        scatter_s = time.perf_counter() - t0
        if not (torch.equal(assigned, res.assigned)
                and torch.equal(mb[: cfg.n, : plan.words], res.mb_packed)):
            raise AssertionError(f"the staged {schedule} run disagrees with substream_match")
        kernel_ms = sorted(runs)[1]
        total = a_slots.numel()
        bound_ms, bound_by = bound(m, plan.n_pad, plan.width)
        report[schedule] = {
            "kernel": name, "launches": launches, "max_memory_allocated": peak,
            "seconds": {"substream_match_call": call_s, "layout_host": layout_s,
                        "kernel": kernel_ms / 1e3, "kernel_runs": [t / 1e3 for t in runs],
                        "scatter": scatter_s},
            "ns_per_edge_kernel": kernel_ms * 1e6 / m, "edges_per_s_kernel": m / (kernel_ms / 1e3),
            "us_per_wave": kernel_ms * 1e3 / sch.num_waves,
            "slots": total, "slot_fill": sch.num_scheduled / total if total else 1.0,
            "segments": int(args[3][-1]),
        }
        if schedule == "mega":
            report[schedule]["tiles"] = int(args[3][-1]) // args[6]
            report[schedule]["seg_block"] = args[6]
        report[schedule]["out"] = {"name": name, "ms": kernel_ms, "bound_ms": bound_ms,
                                   "bound_by": bound_by, "launches": launches[name], "m": m,
                                   "slot_fill": report[schedule]["slot_fill"],
                                   "us_per_wave": report[schedule]["us_per_wave"]}
        del args, slots, a_slots, mb
    # the per-edge kernel on the same (generated) order, once
    args = kernel_inputs(stream, cfg)
    shares = window_share(args[0])
    edges_ms, (a_e, mb_e) = cuda_ms(lambda: kernel.substream_match_packed(*args))
    del args
    for schedule, res in results.items():
        if not (torch.equal(res.assigned, a_e)
                and torch.equal(res.mb_packed, mb_e[: cfg.n, : plan.words])):
            raise AssertionError(f"schedule={schedule!r} differs from the per-edge kernel")
    t0 = time.perf_counter()
    merged = merge_host(stream, results["mega"], cfg)
    merge_s = time.perf_counter() - t0
    check_matching(results["mega"], stream, cfg, merged=merged)
    recorded = int((results["mega"].assigned >= 0).sum())
    weight = float(to_numpy(stream.weight)[merged].sum())
    if not (0 < merged.size <= recorded) or not weight > 0:
        raise AssertionError(f"implausible matching: {merged.size} edges, weight {weight}")
    emit("wave_path", config=config.name, order="generated", scale=config.scale,
         edge_factor=config.edge_factor, L=cfg.L, eps=cfg.eps, n=cfg.n, m=m,
         schedule={"host_seconds": schedule_s, "assign_seconds": sch.schedule_seconds,
                   "pack_seconds": sch.pack_seconds, "waves": sch.num_waves,
                   "segments": sch.num_segments, "fill": sch.fill,
                   "median_wave": float(np.median(sizes)), "max_wave": int(sizes.max())},
         wave_widths=wave_widths(sch),
         engines={k: {kk: vv for kk, vv in v.items() if kk != "out"} for k, v in report.items()},
         edges_kernel_same_order={"ms": edges_ms, "ns_per_edge": edges_ms * 1e6 / m,
                                  "window_share": shares},
         bit_equal_to_edges_kernel=True, merge_host_seconds=merge_s,
         recorded_edges=recorded, matched_edges=int(merged.size), weight=weight,
         check_matching="passed")
    return {v["out"]["name"]: v["out"] for v in report.values()}, sch, results["mega"]


def phase_blocked_wave_route(K):
    """The blocked order (Listing 2) through the wave kernels at a smaller
    scale: ``mwm_pipeline(part1="kernel", schedule=...)`` must give the
    per-edge pipeline's matching; the blocked order leaves few edges per
    wave, which the kernel times show."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import lexicographic_order, mwm_pipeline, permute_stream
    from repro_torch.core.types import to_numpy
    from repro_torch.graph import waves
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import kernel_inputs, mega_inputs, waves_inputs

    config, stream, cfg, gen_s, _ = paper_stream(dataclasses.replace(CONFIG, scale=BLOCKED_WAVE_SCALE))
    routes = {}
    for schedule in ("edges", "mega", "waves"):
        build.launches.clear()
        t0 = time.perf_counter()
        idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=K, schedule=schedule)
        routes[schedule] = {"idx": idx, "weight": weight, "seconds": time.perf_counter() - t0,
                            "launches": dict(build.launches)}
    for schedule in ("mega", "waves"):
        if not np.array_equal(routes[schedule]["idx"], routes["edges"]["idx"]):
            raise AssertionError(f"blocked schedule={schedule!r} differs from the edges pipeline")
        name = kernel.MEGA_NAME if schedule == "mega" else kernel.WAVES_NAME
        if routes[schedule]["launches"].get(name, 0) < 1:
            raise AssertionError(f"the blocked route launched no {name}")
    blocked = permute_stream(stream, lexicographic_order(stream, K))
    src, dst, valid = (to_numpy(t) for t in (blocked.src, blocked.dst, blocked.valid))
    sch = waves.wave_schedule(src, dst, valid=valid)
    sizes = sch.wave_sizes()
    kernel_ms = {
        "edges": cuda_ms(lambda a=kernel_inputs(blocked, cfg): kernel.substream_match_packed(*a))[0],
        "mega": cuda_ms(lambda a=mega_inputs(blocked, cfg, sch)[0]: kernel.substream_match_mega(*a))[0],
        "waves": cuda_ms(lambda a=waves_inputs(blocked, cfg, sch)[0]: kernel.substream_match_waves(*a))[0],
    }
    emit("blocked_wave_route", scale=config.scale, edge_factor=config.edge_factor, L=cfg.L, K=K,
         m=stream.num_edges, generate_host_seconds=gen_s,
         waves=sch.num_waves, segments=sch.num_segments, fill=sch.fill,
         median_wave=float(np.median(sizes)), max_wave=int(sizes.max()),
         schedule_host_seconds=sch.schedule_seconds + sch.pack_seconds,
         kernel_ms=kernel_ms,
         pipelines={k: {"seconds": v["seconds"], "launches": v["launches"],
                        "matched_edges": int(v["idx"].size), "weight": v["weight"]}
                    for k, v in routes.items()},
         equal_to_edges_pipeline=True)


def _ring_checks(results, max_err, rmat_stream, rmat_cfg, packed):
    """The wave kernels of one layout on the streams aimed at their slot ring
    (:data:`repro_torch.testing.cases.WAVE`) at L 64, 300 and 2048, each
    also as its second half seeded with the first half's bits (unpacked:
    set bytes made 5; packed: random bits past L and past n, which must come
    back unchanged), mega at seg_block 1, 2 and 4: equal to the plain
    version on the same operands and, scattered to the stream, to the packed
    per-edge kernel on the stream's order (other code than the shared walk).
    Then the waves kernel on thresholds whose lanes are permuted, and ids,
    weights and a carried block at 4, 8 and 12 (block: 3, 5, 7) bytes past
    their alignment. Adds to ``results`` and ``max_err``."""
    import torch

    from repro_torch.core.bitpack import unpack_bits
    from repro_torch.graph import waves
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import (
        mega_inputs, resolve_stream_schedule, substream_match, waves_inputs,
    )
    from repro_torch.testing.cases import WAVE, at_offset, permuted_lanes, with_pad_bits

    mega_name = kernel.MEGA_NAME if packed else kernel.MEGA_UNPACKED_NAME
    waves_name = kernel.WAVES_NAME if packed else kernel.WAVES_UNPACKED_NAME
    engines = {mega_name: (kernel.substream_match_mega, kernel.substream_match_mega_plain),
               waves_name: (kernel.substream_match_waves, kernel.substream_match_waves_plain)}

    def inputs(name, stream, cfg, sch, sb, mb0):
        if name == mega_name:
            return mega_inputs(stream, cfg, sch, sb, mb0, packed=packed)
        return waves_inputs(stream, cfg, sch, mb0, packed=packed)

    def check(name, label, args, info):
        launch, plain = engines[name]
        a_k, mb_k = launch(*args, packed=packed)
        a_p, mb_p = plain(*args, packed=packed)
        torch.cuda.synchronize()
        err = _compare(a_k, mb_k, a_p, mb_p)
        max_err[name] = max(max_err[name], err)
        results[name][label] = {**info, "equal": err == 0}
        return a_k, mb_k

    for case, fn in WAVE.items():
        for L in (64, 300, 2048):
            stream, cfg, _ = _on_card(fn(L))
            h = stream.num_edges // 2
            head = _head(stream, 0, h)
            mb0_packed = substream_match(head, cfg).mb_packed
            runs = {f"ring_{case}_L{L}": (stream, None, None),
                    f"ring_{case}_L{L}_mb0": (_head(stream, h, stream.num_edges),
                                              mb0_packed if packed
                                              else substream_match(head, cfg, packed=False).mb,
                                              mb0_packed)}
            for label, (st, mb0, mb0_edges) in runs.items():
                sch = resolve_stream_schedule(st)
                want = substream_match(st, cfg, mb0=mb0_edges, packed=True)  # per-edge kernel
                for name, sb in ((mega_name, 1), (mega_name, 2), (mega_name, 4), (waves_name, None)):
                    args, slots = inputs(name, st, cfg, sch, sb, mb0)
                    mask = None
                    if args[-1] is not None and packed:
                        carried, mask = with_pad_bits(args[-1], cfg.n, cfg.L)
                        args = (*args[:-1], carried)
                    elif args[-1] is not None:
                        args = (*args[:-1], args[-1] * 5)
                    key = label if sb is None else f"{label}_sb{sb}"
                    a_k, mb_k = check(name, key, args, {"m": st.num_edges, "L": cfg.L,
                                                        "waves": sch.num_waves,
                                                        "max_wave": sch.max_wave_size})
                    dense = unpack_bits(mb_k, 8 * mb_k.shape[1]) if packed else mb_k.ne(0)
                    same = (torch.equal(waves.scatter_slot_assignments(slots, a_k, st.num_edges),
                                        want.assigned)
                            and torch.equal(dense[: cfg.n, : cfg.L], want.mb))
                    if mask is not None:  # the carried bits outside the vertices' L come back
                        keep = mask[: mb_k.shape[0]]
                        same = same and torch.equal(mb_k & keep, args[-1][: mb_k.shape[0]] & keep)
                    results[name][key]["equal_edges_kernel"] = same
    # the waves kernel on thresholds whose first L lanes are permuted (no passing count staged)
    for label, case in (("rmat12_L64", None), ("ring_mixed_L300", WAVE["mixed"](300)),
                        ("ring_wide_L2048", WAVE["wide"](2048))):
        stream, cfg = (rmat_stream, rmat_cfg) if case is None else _on_card(case)[:2]
        args, _ = inputs(waves_name, stream, cfg, resolve_stream_schedule(stream), None, None)
        check(waves_name, f"{label}_unsorted", (*args[:2], permuted_lanes(args[2], cfg.L), *args[3:]),
              {"m": stream.num_edges, "L": cfg.L})
    # ids and weights inside a 16-byte line, a carried block off its word
    h = rmat_stream.num_edges // 2
    mb0 = substream_match(_head(rmat_stream, 0, h), rmat_cfg, packed=packed)
    tail = _head(rmat_stream, h, rmat_stream.num_edges)
    sch = resolve_stream_schedule(tail)
    for name in engines:
        args, _ = inputs(name, tail, rmat_cfg, sch, 2, mb0.mb_packed if packed else mb0.mb)
        launch, plain = engines[name]
        a_p, mb_p = plain(*args, packed=packed)
        for shift in (1, 2, 3):
            moved = (at_offset(args[0], shift), at_offset(args[1], shift), *args[2:-1],
                     at_offset(args[-1], 2 * shift + 1))
            a_k, mb_k = launch(*moved, packed=packed)
            torch.cuda.synchronize()
            err = _compare(a_k, mb_k, a_p, mb_p)
            max_err[name] = max(max_err[name], err)
            results[name][f"rmat12_L64_mb0_misaligned{4 * shift}"] = {
                "m": tail.num_edges, "L": rmat_cfg.L, "equal": err == 0}


def phase_unpacked_kernels_vs_plain(paper, paper_cfg, K):
    """The three unpacked kernels and their plain versions on the same
    operands on the card: the zoo, the window cases, RMAT scale 12 at L 8,
    13, 64 and 300, RMAT scale 10 at L 2048, a carried bool ``mb0`` (also
    at L 2048), seg_block 1, 2 and 4
    for mega, the 20,000-edge blocked prefix of the paper stream for the
    per-edge kernel and its 200,000-edge generated prefix for the wave
    kernels; the wave kernels also on the ring cases (:func:`_ring_checks`).
    Returns {kernel: (max_abs_err, timings at the prefix)}."""
    import torch

    from repro_torch.core import lexicographic_order, permute_stream
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import (
        MEGA_SEG_BLOCK, kernel_inputs, mega_inputs, resolve_stream_schedule, substream_match,
        waves_inputs,
    )
    from repro_torch.testing.cases import WINDOW, ZOO, rmat_case

    cases = {f"zoo_{name}": _on_card(fn()) for name, fn in ZOO.items()}
    cases.update(_window_cases())
    for L, eps in ((8, 0.1), (13, 0.1), (64, 0.1), (300, 0.01)):
        cases[f"rmat12_L{L}"] = _on_card(rmat_case(12, edge_factor=4, L=L, eps=eps, pad=5))
    cases["rmat10_L2048"] = _on_card(rmat_case(10, edge_factor=4, L=2048, eps=0.002, pad=5))
    rmat12_L64 = cases["rmat12_L64"]
    carried = [(f"rmat12_L{L}", rmat_case(12, edge_factor=4, L=L, eps=eps))
               for L, eps in ((64, 0.1), (300, 0.01))]
    carried.append(("window_hub_L2048", WINDOW["hub"](2048)))
    for label, case in carried:  # carried state: the second half, seeded
        stream, cfg, _ = _on_card(case)
        h = stream.num_edges // 2
        mb0 = substream_match(_head(stream, 0, h), cfg, packed=False).mb
        cases[f"{label}_mb0"] = (_head(stream, h, stream.num_edges), cfg, mb0)
    blocked = permute_stream(paper, lexicographic_order(paper, K))
    edge_prefix = "paper_blocked_prefix"
    wave_prefix = "paper_generated_prefix"
    cases[edge_prefix] = (_head(blocked, 0, PLAIN_PREFIX), paper_cfg, None)
    cases[wave_prefix] = (_head(paper, 0, WAVE_PLAIN_PREFIX), paper_cfg, None)
    del blocked

    names = (kernel.UNPACKED_NAME, kernel.MEGA_UNPACKED_NAME, kernel.WAVES_UNPACKED_NAME)
    plains = {kernel.UNPACKED_NAME: kernel.substream_match_unpacked_plain,
              kernel.MEGA_UNPACKED_NAME: functools.partial(kernel.substream_match_mega_plain,
                                                           packed=False),
              kernel.WAVES_UNPACKED_NAME: functools.partial(kernel.substream_match_waves_plain,
                                                            packed=False)}
    launches = {kernel.UNPACKED_NAME: kernel.substream_match_unpacked,
                kernel.MEGA_UNPACKED_NAME: functools.partial(kernel.substream_match_mega,
                                                             packed=False),
                kernel.WAVES_UNPACKED_NAME: functools.partial(kernel.substream_match_waves,
                                                              packed=False)}
    results = {name: {} for name in names}
    max_err = dict.fromkeys(names, 0)
    timed = {}
    for case, (stream, cfg, mb0) in cases.items():
        variants = []
        if case != wave_prefix:
            variants.append((kernel.UNPACKED_NAME, None,
                             kernel_inputs(stream, cfg, mb0, packed=False), stream.num_edges))
        if case != edge_prefix:
            sch = resolve_stream_schedule(stream)
            for sb in (MEGA_SEG_BLOCK,) if case == wave_prefix else (1, 2, 4):
                variants.append((kernel.MEGA_UNPACKED_NAME, sb,
                                 mega_inputs(stream, cfg, sch, sb, mb0, packed=False)[0], sch))
            variants.append((kernel.WAVES_UNPACKED_NAME, None,
                             waves_inputs(stream, cfg, sch, mb0, packed=False)[0], sch))
        for name, sb, args, info in variants:
            a_k, mb_k = launches[name](*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a_p, mb_p = plains[name](*args)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = _compare(a_k, mb_k, a_p, mb_p)
            max_err[name] = max(max_err[name], err)
            label = case if sb is None else f"{case}_sb{sb}"
            results[name][label] = {"m": stream.num_edges, "L": cfg.L, "equal": err == 0,
                                    **({} if name == kernel.UNPACKED_NAME
                                       else {"waves": info.num_waves})}
            if case in (edge_prefix, wave_prefix):
                ms, _ = cuda_ms(lambda: launches[name](*args), reps=5)
                n_pad = args[3] if name == kernel.UNPACKED_NAME else args[4]
                width = args[2].shape[-1]
                timed[name] = {"plain_ms": plain_s * 1e3, "ms_at_plain_m": ms,
                               "plain_m": stream.num_edges,
                               "bound_ms_at_plain_m": bound(stream.num_edges, n_pad, width,
                                                            packed=False)[0]}
    _ring_checks(results, max_err, *rmat12_L64[:2], packed=False)
    for name in names:
        emit("kernel_vs_plain", kernel=name, cases=results[name], max_abs_err=max_err[name],
             **timed[name])
        bad = [k for k, v in results[name].items()
               if not (v["equal"] and v.get("equal_edges_kernel", True))]
        if bad:
            raise AssertionError(f"{name} differs from its plain version on {bad}")
    return {name: (max_err[name], timed[name]) for name in names}


def phase_unpacked_main_path(config, stream, cfg, packed_main):
    """The unpacked main path once through the public entry point,
    ``mwm_pipeline(part1="kernel", packed=False)``, counted; then the sort
    and the unpacked per-edge kernel staged and timed. ``assigned``, the
    dense bits, the merged edges and the weight must equal the packed main
    path's. Returns the kernel's row and the blocked stream's one-shot run
    for the epoch path."""
    import numpy as np
    import torch

    from repro_torch.core import (
        MatchingResult, check_matching, lexicographic_order, mwm_pipeline, permute_stream,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import device_plan, kernel_inputs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    t0 = time.perf_counter()
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=config.K, packed=False)
    pipeline_s = time.perf_counter() - t0
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches.get(kernel.UNPACKED_NAME, 0) < 1:
        raise AssertionError(f"the unpacked main path launched no {kernel.UNPACKED_NAME}: {launches}")
    order = lexicographic_order(stream, config.K)
    blocked = permute_stream(stream, order)
    args = kernel_inputs(blocked, cfg, packed=False)
    runs = []
    for _ in range(3):
        ms, (a_blk, mb) = cuda_ms(lambda: kernel.substream_match_unpacked(*args))
        runs.append(ms)
    del args
    kernel_ms = sorted(runs)[1]
    plan = device_plan(cfg.n, cfg.L, packed=False)
    assigned = torch.empty_like(a_blk)
    assigned[order] = a_blk
    dense = mb[: cfg.n, : cfg.L].ne(0)
    result = MatchingResult(assigned, mb=dense)
    want = packed_main["result"]
    same = {
        "assigned": torch.equal(assigned, want.assigned),
        "mb_dense_vs_packed_unpacked": torch.equal(dense, want.mb),
        "merged_edges": bool(np.array_equal(idx, packed_main["idx"])),
        "weight": weight == packed_main["weight"],
    }
    if not all(same.values()):
        raise AssertionError(f"the unpacked main path differs from the packed one: {same}")
    t0 = time.perf_counter()
    check_matching(result, stream, cfg, merged=idx)
    check_s = time.perf_counter() - t0
    m = stream.num_edges
    bound_ms, bound_by = bound(m, plan.n_pad, plan.width, packed=False)
    emit("unpacked_main_path", config=config.name, scale=config.scale, L=cfg.L, K=config.K,
         n=cfg.n, m=m, bit_block_bytes=plan.nbytes, row_bytes=plan.width, fits_l2=plan.fits_l2,
         seconds={"pipeline": pipeline_s, "kernel": kernel_ms / 1e3,
                  "kernel_runs": [t / 1e3 for t in runs], "check_matching": check_s},
         ns_per_edge_kernel=kernel_ms * 1e6 / m, edges_per_s_pipeline=m / pipeline_s,
         packed_kernel_ms=packed_main["ms"], unpacked_over_packed=kernel_ms / packed_main["ms"],
         launches=launches, max_memory_allocated=peak, matched_edges=int(idx.size),
         weight=weight, bit_equal_to_packed=same, bound_ms=bound_ms, bound_by=bound_by,
         check_matching="passed")
    return {"name": kernel.UNPACKED_NAME, "m": m, "ms": kernel_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "launches": launches[kernel.UNPACKED_NAME],
            "fits_l2": plan.fits_l2, "blocked": blocked, "one_shot": (a_blk, dense)}


def phase_unpacked_wave_path(config, stream, cfg, sch, packed_mega):
    """The unpacked wave kernels at full size on the wave path's schedule
    (generated order, passed, not rebuilt): ``substream_match(schedule=
    "mega"|"waves", packed=False)`` counted alone, each bit-equal to the
    packed mega result; then the kernels staged and timed."""
    import torch

    from repro_torch.graph import waves
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import (
        device_plan, mega_inputs, substream_match, waves_inputs,
    )

    m = stream.num_edges
    plan = device_plan(cfg.n, cfg.L, packed=False)
    engines = {"mega": (kernel.MEGA_UNPACKED_NAME,
                        functools.partial(kernel.substream_match_mega, packed=False), mega_inputs),
               "waves": (kernel.WAVES_UNPACKED_NAME,
                         functools.partial(kernel.substream_match_waves, packed=False),
                         waves_inputs)}
    want_mb = packed_mega.mb
    out, report = {}, {}
    for schedule, (name, launch, inputs) in engines.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launches.clear()
        t0 = time.perf_counter()
        res = substream_match(stream, cfg, schedule=schedule, waves=sch, packed=False)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = dict(build.launches)
        peak = torch.cuda.max_memory_allocated()
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the unpacked wave path launched no {name}: {launches}")
        if not (torch.equal(res.assigned, packed_mega.assigned) and torch.equal(res.mb, want_mb)):
            raise AssertionError(f"unpacked schedule={schedule!r} differs from the packed mega run")
        args, slots = (inputs(stream, cfg, sch, packed=False) if schedule == "waves"
                       else inputs(stream, cfg, sch, None, packed=False))
        runs = []
        for _ in range(3):
            ms, (a_slots, mb) = cuda_ms(lambda: launch(*args))
            runs.append(ms)
        assigned = waves.scatter_slot_assignments(slots, a_slots, m)
        if not (torch.equal(assigned, res.assigned)
                and torch.equal(mb[: cfg.n, : cfg.L].ne(0), res.mb)):
            raise AssertionError(f"the staged unpacked {schedule} run disagrees with the call")
        kernel_ms = sorted(runs)[1]
        total = a_slots.numel()
        bound_ms, bound_by = bound(m, plan.n_pad, plan.width, packed=False)
        fill = sch.num_scheduled / total if total else 1.0
        report[schedule] = {"kernel": name, "launches": launches, "max_memory_allocated": peak,
                            "seconds": {"substream_match_call": call_s, "kernel": kernel_ms / 1e3,
                                        "kernel_runs": [t / 1e3 for t in runs]},
                            "ns_per_edge_kernel": kernel_ms * 1e6 / m,
                            "us_per_wave": kernel_ms * 1e3 / sch.num_waves,
                            "slots": total, "slot_fill": fill}
        out[name] = {"name": name, "m": m, "ms": kernel_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "launches": launches[name], "slot_fill": fill,
                     "fits_l2": plan.fits_l2, "us_per_wave": kernel_ms * 1e3 / sch.num_waves}
        del args, slots, a_slots, mb, res
    emit("unpacked_wave_path", order="generated", scale=config.scale, L=cfg.L, n=cfg.n, m=m,
         waves=sch.num_waves, wave_widths=wave_widths(sch), bit_block_bytes=(plan.n_pad + kernel.SACRIFICIAL_ROWS) * plan.width,
         fits_l2=plan.fits_l2, engines=report, bit_equal_to_packed_mega=True)
    return out


def phase_epoch_path(cfg, unpacked):
    """``match_epochs`` at full size on the blocked paper stream through the
    unpacked per-edge kernel: 4 epochs equal to the one-shot run, and a
    second run from the state after epoch 2 equal too; then the wave
    kernels' epochs at scale 16 in generated order, both layouts, each
    equal to its one-shot run."""
    import dataclasses

    import torch

    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import match_epochs, substream_match

    blocked = unpacked["blocked"]
    want_a, want_mb = unpacked["one_shot"]

    def run(**kw):
        marks, states = [time.perf_counter()], {}

        def hook(k, st):
            marks.append(time.perf_counter())
            states[k] = st

        build.launches.clear()
        t0 = time.perf_counter()
        res = match_epochs(blocked, cfg, epochs=4, engine="edges", packed=False,
                           epoch_hook=hook, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not (torch.equal(res.assigned, want_a) and torch.equal(res.mb, want_mb)):
            raise AssertionError(f"match_epochs({sorted(kw)}) differs from the one-shot run")
        return {"seconds": seconds, "epochs_run": sorted(states),
                "epoch_seconds": [b - a for a, b in zip(marks, marks[1:])],
                "launches": dict(build.launches)}, states

    full, states = run()
    if full["launches"].get(kernel.UNPACKED_NAME, 0) != 4:
        raise AssertionError(f"4 epochs launched {full['launches']}")
    resumed, _ = run(state=states[1])
    if resumed["epochs_run"] != [2, 3]:
        raise AssertionError(f"the resumed run ran epochs {resumed['epochs_run']}")
    del states

    small = dataclasses.replace(CONFIG, scale=BLOCKED_WAVE_SCALE)
    _, stream, small_cfg, gen_s, _ = paper_stream(small)
    waves_runs = {}
    for engine in ("mega", "waves"):
        for packed in (True, False):
            t0 = time.perf_counter()
            one = substream_match(stream, small_cfg, schedule=engine, packed=packed)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            build.launches.clear()
            t0 = time.perf_counter()
            ep = match_epochs(stream, small_cfg, epochs=4, engine=engine, packed=packed)
            torch.cuda.synchronize()
            ep_s = time.perf_counter() - t0
            if not (torch.equal(ep.assigned, one.assigned) and torch.equal(ep.mb, one.mb)):
                raise AssertionError(f"match_epochs(engine={engine!r}, packed={packed}) "
                                     "differs from its one-shot run")
            waves_runs[f"{engine}_{'packed' if packed else 'unpacked'}"] = {
                "one_shot_seconds": one_s, "epochs_seconds": ep_s,
                "launches": dict(build.launches)}
    emit("epoch_path", engine="edges", layout="unpacked", order="blocked", m=blocked.num_edges,
         epochs=4, full=full, resumed_from_epoch=2, resumed=resumed,
         equal_to_one_shot=True, scale16_generated={"m": stream.num_edges,
                                                    "generate_host_seconds": gen_s,
                                                    "runs": waves_runs})
    return full


def phase_merge_device(stream, cfg, main):
    """Part 2 on the card at full size: ``merge_device`` through the public
    entry point, counted, equal to ``merge_host``'s indices, and timed again
    in a second call; then staged:
    the merge order (nonzero and one stable sort of the R recorded edges),
    the one-substream operands, the packed per-edge kernel at L = 1 (CUDA
    events, median of 3) and the scatter back to stream positions. The
    L = 1 kernel also meets its plain version on the first PLAIN_PREFIX
    edges of the merge order. Returns the kernel's figures at L = 1."""
    import numpy as np
    import torch

    from repro_torch.core import EdgeStream, SubstreamConfig
    from repro_torch.core.merge import merge_order
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import device_plan, kernel_inputs, merge_device

    result = main["result"]
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    mask = merge_device(stream, result, cfg)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dict(build.launches)
    if launches.get(kernel.NAME, 0) < 1:
        raise AssertionError(f"merge_device launched no {kernel.NAME}: {launches}")
    idx = torch.nonzero(mask).flatten().cpu().numpy()
    if not np.array_equal(idx, main["idx"]):
        raise AssertionError("merge_device differs from merge_host")
    t0 = time.perf_counter()
    again = merge_device(stream, result, cfg)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    if not torch.equal(again, mask):
        raise AssertionError("a second merge_device differs from the first")
    order_ms, order = cuda_ms(lambda: merge_order(result, cfg))
    r = order.numel()
    one_cfg = SubstreamConfig(n=cfg.n, L=1, eps=cfg.eps)

    def operands():
        ones = torch.ones(r, dtype=torch.float32, device=stream.device)
        one = EdgeStream(src=stream.src[order], dst=stream.dst[order], weight=ones,
                         valid=ones.bool())
        return kernel_inputs(one, one_cfg)

    operands_ms, args = cuda_ms(operands)
    runs, out = [], None
    for _ in range(3):
        ms, out = cuda_ms(lambda: kernel.substream_match_packed(*args))
        runs.append(ms)
    kernel_ms = sorted(runs)[1]

    def scatter():
        staged = torch.zeros(stream.num_edges, dtype=torch.bool, device=stream.device)
        staged[order] = out[0] >= 0
        return staged

    scatter_ms, staged = cuda_ms(scatter)
    if not torch.equal(staged, mask):
        raise AssertionError("the staged merge disagrees with merge_device")
    prefix = (args[0][:PLAIN_PREFIX], args[1][:PLAIN_PREFIX], *args[2:])
    a_k, mb_k = kernel.substream_match_packed(*prefix)
    t0 = time.perf_counter()
    a_p, mb_p = kernel.substream_match_packed_plain(*prefix)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = _compare(a_k, mb_k, a_p, mb_p)
    plan = device_plan(cfg.n, 1)
    bound_ms, bound_by = bound(r, plan.n_pad, plan.width)
    shares = window_share(args[0])
    emit("merge_device", m=stream.num_edges, recorded_edges=r, matched_edges=int(idx.size),
         equal_to_merge_host=True, launches=launches, row_bytes=plan.width,
         seconds={"merge_device_call": call_s, "merge_device_call_again": again_s,
                  "merge_host": main["merge_host_s"],
                  "order": order_ms / 1e3, "operands": operands_ms / 1e3,
                  "kernel_L1": kernel_ms / 1e3, "kernel_L1_runs": [t / 1e3 for t in runs],
                  "scatter": scatter_ms / 1e3},
         ns_per_recorded_edge_kernel=kernel_ms * 1e6 / max(r, 1),
         host_over_device=main["merge_host_s"] / call_s, window_share=shares,
         kernel_L1_vs_plain={"m": int(prefix[0].shape[0]), "max_abs_err": err,
                             "plain_ms": plain_s * 1e3},
         bound_ms_L1=bound_ms, bound_by_L1=bound_by)
    if err:
        raise AssertionError(f"the L = 1 kernel differs from its plain version: {err}")
    return {"launches": launches[kernel.NAME], "recorded_edges": r, "ms": kernel_ms,
            "max_abs_err": err}


def phase_main_telemetry(config, stream, cfg, main):
    """The main path again with an enabled ``Telemetry``: the same matching,
    one ``kernel_edges`` record whose stage split holds together, its
    roofline, and the pipeline's time beside the main path's (telemetry
    off)."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import mwm_pipeline
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel

    tel = obs.Telemetry()
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=config.K, telemetry=tel)
    pipeline_s = time.perf_counter() - t0
    launches = dict(build.launches)
    if launches.get(kernel.NAME, 0) < 1:
        raise AssertionError(f"the telemetry run launched no {kernel.NAME}: {launches}")
    if not (np.array_equal(idx, main["idx"]) and weight == main["weight"]):
        raise AssertionError("the main path with telemetry differs from the one without")
    rec, = tel.match_calls
    problems = obs.consistency_problems(rec.stage_seconds, rec.wall_seconds)
    roofline = {k: v for k, v in rec.roofline().items() if v != float("inf")}  # JSON has no inf
    emit("main_path_telemetry", record=rec.asdict(), roofline=roofline,
         consistency_problems=problems, events=tel.events,
         pipeline_seconds={"telemetry_on": pipeline_s, "telemetry_off": main["pipeline_s"]},
         launches=launches)
    if problems or rec.backend != stream.device.type or rec.engine != "kernel_edges":
        raise AssertionError(f"telemetry record: {rec.engine} {rec.backend} {problems}")


def phase_validate(stream, cfg):
    """``validate_stream`` at full size in both modes, on the clean paper
    stream (it must pass untouched) and on a copy with two NaN weights and
    two ids on the sacrificial row (strict names exactly those; sanitize
    drops exactly those, nothing else changes)."""
    import torch

    from repro_torch.core import StreamValidationError, validate_stream
    from repro_torch.testing import faultline

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    seconds = {}
    for policy in ("strict", "sanitize"):
        seconds[f"clean_{policy}"], (out, report) = timed(
            lambda: validate_stream(stream, cfg.n, policy=policy))
        if out is not stream or not report.ok or report.num_valid_in != stream.num_edges:
            raise AssertionError(f"{policy} changed a clean stream: {report}")
    m = stream.num_edges
    t0 = time.perf_counter()
    dirty, w_fault = faultline.poison_weights(stream, (1, m // 3), "nan")
    dirty, id_fault = faultline.poison_ids(dirty, cfg.n, (m // 2, m - 1), "sacrificial")
    torch.cuda.synchronize()
    seconds["poison_copy_setup"] = time.perf_counter() - t0
    want = {w_fault.kind: w_fault.positions, id_fault.kind: id_fault.positions}

    def strict():
        try:
            validate_stream(dirty, cfg.n, policy="strict")
        except StreamValidationError as err:
            return err
        raise AssertionError("strict let a poisoned stream through")

    seconds["poisoned_strict"], err = timed(strict)
    got = {p.kind: p.indices for p in err.problems}
    if got != want:
        raise AssertionError(f"strict named {got}, planted {want}")
    seconds["poisoned_sanitize"], (clean, report) = timed(
        lambda: validate_stream(dirty, cfg.n, policy="sanitize"))
    dropped = torch.nonzero(~clean.valid).flatten().tolist()
    keep = clean.valid
    same = all(torch.equal(a[keep], b[keep]) for a, b in
               ((clean.src, stream.src), (clean.dst, stream.dst), (clean.weight, stream.weight)))
    if report.num_dropped != 4 or sorted(dropped) != sorted((1, m // 3, m // 2, m - 1)) or not same:
        raise AssertionError(f"sanitize dropped {dropped} ({report.num_dropped})")
    emit("validate", m=m, n=cfg.n, seconds=seconds, planted=want, strict_message=str(err)[:300],
         sanitize_report=report.counters())


def phase_fallback():
    """The fallback ladder on the card, both layouts. On the card it holds
    only kernel rungs and steps down only on a plan refusal, raised before
    any launch. At scale 16 in generated order (one host schedule, passed
    to every call): clean (no fallback, the asked kernel launched once), the
    mega rung refused once (mega[seg_block=1] delivers), the mega rungs
    refused (the waves kernel delivers), and with nothing left for mega,
    waves and edges: FallbackExhaustedError naming every kernel rung and no
    launch. A failure that is no refusal (an injected launch error)
    propagates with no fallback event. At L = 2049 every kernel rung
    refuses the row before a launch and the ladder is exhausted. Every
    result equals the clean one-shot run bit for bit."""
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import (
        FallbackExhaustedError, PlanRefusedError, resolve_stream_schedule, substream_match,
    )
    from repro_torch.testing import faultline
    from repro_torch.testing.cases import rmat_case

    def name_of(schedule, packed):
        names = {("edges", True): kernel.NAME, ("edges", False): kernel.UNPACKED_NAME,
                 ("mega", True): kernel.MEGA_NAME, ("mega", False): kernel.MEGA_UNPACKED_NAME,
                 ("waves", True): kernel.WAVES_NAME, ("waves", False): kernel.WAVES_UNPACKED_NAME}
        return names[schedule, packed]

    def ladder(stream, cfg, want, schedule, packed, inject, waves=None):
        tel = obs.Telemetry()
        torch.cuda.synchronize()
        build.launches.clear()
        t0 = time.perf_counter()
        try:
            with inject:
                res = substream_match(stream, cfg, schedule=schedule, packed=packed, waves=waves,
                                      on_plan_failure="fallback", telemetry=tel)
            torch.cuda.synchronize()
            outcome = "equal" if (torch.equal(res.assigned, want.assigned)
                                  and torch.equal(res.mb, want.mb)) else "DIFFERS"
        except FallbackExhaustedError as err:
            outcome = "exhausted: " + ", ".join(label for label, _ in err.attempts)
        except faultline.InjectedFailure as err:
            outcome = f"raised: {type(err).__name__}"
        events = [e for e in tel.events if e["name"] == "fallback"]
        return {"seconds": time.perf_counter() - t0, "outcome": outcome,
                "fallback_count": tel.counters.get("fallback.count"),
                "rungs_failed": [e["from_engine"] for e in events],
                "records": [r.engine for r in tel.match_calls],
                "reasons": sorted({e["reason"][:80] for e in events}),
                "launches": dict(build.launches)}

    def refused(*targets):
        return faultline.failing(*targets, exc_type=PlanRefusedError)

    small16 = dataclasses.replace(CONFIG, scale=BLOCKED_WAVE_SCALE)
    _, stream, cfg, gen_s, _ = paper_stream(small16)
    sch = resolve_stream_schedule(stream)
    results, problems = {}, []
    for packed in (True, False):
        layout = "packed" if packed else "unpacked"
        want = substream_match(stream, cfg, packed=packed)
        mega, waves_k, edges_k = (name_of(k, packed) for k in ("mega", "waves", "edges"))
        runs = {  # schedule, injection, fallback events, outcome, launches
            "mega_clean": ("mega", contextlib.nullcontext(), 0, "equal", {mega: 1}),
            "mega_refused_once": ("mega", faultline.flaky("mega_device", times=1,
                                                          exc_type=PlanRefusedError),
                                  1, "equal", {mega: 1}),
            "mega_refused": ("mega", refused("mega_device"), 2, "equal", {waves_k: 1}),
            "mega_exhausted": ("mega", refused("mega_device", "waves_device"), 3,
                               "exhausted: mega, mega[seg_block=1], waves", {}),
            "mega_launch_error": ("mega", faultline.failing("mega_device"), 0,
                                  "raised: InjectedFailure", {}),
            "waves_clean": ("waves", contextlib.nullcontext(), 0, "equal", {waves_k: 1}),
            "waves_exhausted": ("waves", refused("wave_plan"), 1, "exhausted: waves", {}),
            "edges_clean": ("edges", contextlib.nullcontext(), 0, "equal", {edges_k: 1}),
            "edges_exhausted": ("edges", refused("edges_device"), 1, "exhausted: edges", {}),
        }
        for label, (schedule, inject, n_events, outcome, launches) in runs.items():
            out = ladder(stream, cfg, want, schedule, packed, inject,
                         waves=None if schedule == "edges" else sch)
            results[f"scale16_{layout}_{label}"] = out
            if (out["outcome"] != outcome or out["fallback_count"] != n_events
                    or out["launches"] != launches
                    or {"waves_xla", "scan"} & set(out["records"])):
                problems.append(f"scale16_{layout}_{label}: {out}")
    wide = rmat_case(7, edge_factor=4, L=2049, eps=0.002, seed=9)
    wide_stream, wide_cfg, _ = _on_card(wide)
    wide_exhausted = {"edges": "edges", "waves": "waves",
                      "mega": "mega, mega[seg_block=1], waves"}
    for packed in (True, False):
        layout = "packed" if packed else "unpacked"
        for schedule, rungs in wide_exhausted.items():
            out = ladder(wide_stream, wide_cfg, None, schedule, packed, contextlib.nullcontext())
            results[f"L2049_{layout}_{schedule}"] = out
            if (out["outcome"] != f"exhausted: {rungs}" or out["launches"]
                    or out["fallback_count"] != rungs.count(",") + 1
                    or not all("width" in r for r in out["reasons"])):
                problems.append(f"L2049_{layout}_{schedule}: {out}")
    emit("fallback_ladder", scale=BLOCKED_WAVE_SCALE, m=stream.num_edges, generate_host_seconds=gen_s,
         wide_L=wide_cfg.L, wide_m=wide_stream.num_edges, runs=results)
    if problems:
        raise AssertionError("fallback ladder: " + "; ".join(problems))


def phase_epoch_snapshots(cfg, unpacked, epoch_full):
    """The epoch path at full size (blocked order, unpacked per-edge kernel,
    4 epochs) with a ``SnapshotManager`` in a temporary directory: a run
    with a snapshot per epoch (against ``epoch_path``'s run without), one
    killed after epoch 2, and its resume from disk with one transient flake
    in the kernel's seam retried by an ``ExecutionGuard``; then one killed
    after epoch 2 while epoch 2's snapshot is still being written (the
    power fails inside its commit, so that write is lost), whose resume
    replays epochs 2 and 3; every finished run equal to the one-shot run."""
    import os
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.checkpoint import SnapshotManager
    from repro_torch.core import ExecutionGuard
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import epoch_bounds, match_epochs
    from repro_torch.testing import faultline

    blocked = unpacked["blocked"]
    want_a, want_mb = unpacked["one_shot"]
    kw = dict(epochs=4, engine="edges", packed=False)

    def check(res, what):
        if not (torch.equal(res.assigned, want_a) and torch.equal(res.mb, want_mb)):
            raise AssertionError(f"{what} differs from the one-shot run")

    def du(path):
        return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_snapshots_") as tmp:
        build.launches.clear()
        tel = obs.Telemetry()
        t0 = time.perf_counter()
        res = match_epochs(blocked, cfg, snapshots=SnapshotManager(f"{tmp}/full", keep=1,
                                                                   telemetry=tel), **kw)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        check(res, "the snapshotted run")
        full_launches = dict(build.launches)
        save_spans = [e["dur"] / 1e6 for e in tel.tracer.events if e["name"] == "snapshot.save"]
        snapshot_bytes = du(f"{tmp}/full")
        t0 = time.perf_counter()
        killed = False
        run_snapshots = SnapshotManager(f"{tmp}/run", keep=0)
        try:
            match_epochs(blocked, cfg, snapshots=run_snapshots,
                         epoch_hook=faultline.kill_at_epoch(2), **kw)
        except faultline.SimulatedCrash:
            killed = True
        killed_s = time.perf_counter() - t0
        run_snapshots.wait()  # the writes already queued land, as a live writer would finish them
        committed = SnapshotManager(f"{tmp}/run").all_positions()
        tel = obs.Telemetry()
        guard = ExecutionGuard(retries=2, telemetry=tel)
        build.launches.clear()
        t0 = time.perf_counter()
        with faultline.flaky("edges_device", times=1):
            res = match_epochs(blocked, cfg, snapshots=SnapshotManager(f"{tmp}/run", telemetry=tel),
                               guard=guard, telemetry=tel, **kw)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        check(res, "the resumed run")
        resumed_launches = dict(build.launches)
        restore_s = [e["dur"] / 1e6 for e in tel.tracer.events if e["name"] == "snapshot.restore"]
        replayed = [e["epoch"] for e in tel.events if e["name"] == "epoch.index"]
        retries = tel.counters.get("guard.retry")
        lost = SnapshotManager(f"{tmp}/lost", keep=0)
        commit, commits = lost.manager._commit, []

        def power_fails_in_third_commit(tmp_dir, final):
            commits.append(final)
            if len(commits) == 3:
                raise faultline.SimulatedCrash(f"killed mid-snapshot before rename of {tmp_dir}")
            commit(tmp_dir, final)

        lost.manager._commit = power_fails_in_third_commit
        try:
            match_epochs(blocked, cfg, snapshots=lost, epoch_hook=faultline.kill_at_epoch(2), **kw)
        except faultline.SimulatedCrash:
            pass
        try:
            lost.wait()  # the writer reaches the failed commit; the writes before it landed
            write_lost = False
        except faultline.SimulatedCrash:
            write_lost = True
        committed_lost = SnapshotManager(f"{tmp}/lost").all_positions()
        tel = obs.Telemetry()
        t0 = time.perf_counter()
        res = match_epochs(blocked, cfg, snapshots=SnapshotManager(f"{tmp}/lost", telemetry=tel),
                           telemetry=tel, **kw)
        torch.cuda.synchronize()
        lost_resumed_s = time.perf_counter() - t0
        check(res, "the run resumed after a lost snapshot write")
        replayed_lost = [e["epoch"] for e in tel.events if e["name"] == "epoch.index"]
    bounds = epoch_bounds(blocked.num_edges, 4)
    emit("epoch_snapshots", m=blocked.num_edges, epochs=4,
         seconds={"with_snapshots": full_s, "without_snapshots": epoch_full["seconds"],
                  "per_epoch_snapshot_cost": (full_s - epoch_full["seconds"]) / 4,
                  "snapshot_save_enqueue": save_spans, "killed_run": killed_s,
                  "resumed_run": resumed_s, "restore": restore_s,
                  "resumed_after_lost_write": lost_resumed_s},
         snapshot_dir_bytes=snapshot_bytes, committed_before_kill=committed,
         replayed_epochs=replayed, guard_retries=retries, launches_full=full_launches,
         launches_resumed=resumed_launches, lost_write=write_lost,
         committed_before_lost_write=committed_lost, replayed_after_lost_write=replayed_lost,
         equal_to_one_shot=True)
    if not killed or committed != bounds[1:4] or replayed != [3] or retries != 1:
        raise AssertionError(f"snapshots: killed={killed} committed={committed} "
                             f"replayed={replayed} retries={retries}")
    if not write_lost or committed_lost != bounds[1:3] or replayed_lost != [2, 3]:
        raise AssertionError(f"lost snapshot write: lost={write_lost} committed={committed_lost} "
                             f"replayed={replayed_lost}")
    if full_launches.get(kernel.UNPACKED_NAME) != 4 or resumed_launches.get(kernel.UNPACKED_NAME) != 1:
        raise AssertionError(f"epoch launches {full_launches} / {resumed_launches}")


def _rounds(stream, cfg, max_rounds=0):
    """``mwm_rounds`` (packed) timed with CUDA events, with its telemetry
    counters and the peak device memory."""
    import torch

    from repro_torch import obs
    from repro_torch.core import mwm_rounds

    tel = obs.Telemetry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, res = cuda_ms(lambda: mwm_rounds(stream, cfg, max_rounds=max_rounds, packed=True,
                                         telemetry=tel))
    c = tel.match_calls[-1].counters
    return res, {"rounds": c["rounds.rounds"], "converged": c["rounds.converged"],
                 "seconds": ms / 1e3, "ms_per_round": ms / max(c["rounds.rounds"], 1),
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _equal_to_edges_kernel(res, stream, cfg, label):
    """``res`` must equal the packed per-edge kernel on the same order."""
    import torch

    from repro_torch.kernels.substream_match.ops import substream_match

    edges = substream_match(stream, cfg)
    if not (torch.equal(res.assigned, edges.assigned)
            and torch.equal(res.mb_packed, edges.mb_packed)):
        raise AssertionError(f"mwm_rounds differs from the per-edge kernel ({label})")
    return edges


def phase_rounds_path(config, stream, cfg, main):
    """The parallel-rounds engine at the paper config, generated order:
    ``mwm_rounds`` bit-equal to the packed per-edge kernel, its rounds,
    seconds and peak memory; ``mwm_pipeline(part1="rounds")`` beside the
    main path's ``part1="kernel"``; then the blocked order, at full width
    when its rounds fit in ROUNDS_BLOCKED_BUDGET_S, else at scale 16."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import lexicographic_order, merge_host, mwm_pipeline, permute_stream
    from repro_torch.kernels import build

    m = stream.num_edges
    build.launches.clear()
    res, gen = _rounds(stream, cfg)
    launches = dict(build.launches)
    if not gen["converged"]:
        raise AssertionError("mwm_rounds stopped before its fixed point")
    if gen["max_memory_allocated"] > ROUNDS_PEAK_LIMIT:
        raise AssertionError(f"mwm_rounds peaked at {gen['max_memory_allocated']} bytes")
    edges = _equal_to_edges_kernel(res, stream, cfg, "generated order")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, weight = mwm_pipeline(stream, cfg, part1="rounds")
    pipeline_s = time.perf_counter() - t0
    if not np.array_equal(idx, merge_host(stream, edges, cfg)):
        raise AssertionError("mwm_pipeline(part1='rounds') differs from the per-edge kernel's merge")
    del res, edges
    budget_rounds = max(1, int(ROUNDS_BLOCKED_BUDGET_S / (gen["ms_per_round"] / 1e3)))
    blocked = permute_stream(stream, lexicographic_order(stream, config.K))
    res, blk = _rounds(blocked, cfg, max_rounds=budget_rounds)
    blk.update(scale=config.scale, budget_rounds=budget_rounds)
    if blk["converged"]:
        _equal_to_edges_kernel(res, blocked, cfg, "blocked order")
    else:
        del res, blocked
        blk["reason"] = (f"the blocked order needs more than {budget_rounds} rounds at "
                         f"{gen['ms_per_round']:.1f} ms a round (> {ROUNDS_BLOCKED_BUDGET_S} s); "
                         f"run at scale {ROUNDS_BLOCKED_FALLBACK_SCALE}")
        print(f"rounds_path: {blk['reason']}", flush=True)
        small, s_stream, s_cfg, _, _ = paper_stream(
            dataclasses.replace(config, scale=ROUNDS_BLOCKED_FALLBACK_SCALE))
        blocked = permute_stream(s_stream, lexicographic_order(s_stream, config.K))
        res, blk["at_fallback_scale"] = _rounds(blocked, s_cfg)
        _equal_to_edges_kernel(res, blocked, s_cfg, f"blocked order, scale {small.scale}")
    del res, blocked
    emit("rounds_path", config=config.name, scale=config.scale, L=cfg.L, n=cfg.n, m=m,
         generated=gen, blocked=blk, launches=launches,
         bit_equal_to_edges_kernel=True,
         pipeline_seconds={"rounds": pipeline_s, "kernel": main["pipeline_s"]},
         edges_per_s_pipeline={"rounds": m / pipeline_s, "kernel": m / main["pipeline_s"]},
         matched_edges=int(idx.size), weight=weight)


def phase_rounds_sharded(config):
    """``mwm_rounds_sharded`` on a 1x1 NCCL mesh (world size 1, a file
    store under ``build/``) at SHARDED_SCALE, equal to ``mwm_rounds``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core import mwm_rounds, mwm_rounds_sharded
    from repro_torch.distributed import RemeshPlan, build_mesh

    _, stream, cfg, _, _ = paper_stream(dataclasses.replace(config, scale=SHARDED_SCALE))
    want_ms, want = cuda_ms(lambda: mwm_rounds(stream, cfg))
    store = ROOT / "build" / "rounds_sharded.store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        mesh = build_mesh(RemeshPlan(data=1, model=1, pod=0, dropped_devices=0))
        ms, got = cuda_ms(lambda: mwm_rounds_sharded(stream, cfg, mesh))
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    equal = torch.equal(got.assigned, want.assigned) and torch.equal(got.mb, want.mb)
    emit("rounds_sharded", mesh={"data": 1, "model": 1}, backend="nccl", scale=SHARDED_SCALE,
         L=cfg.L, m=stream.num_edges, seconds={"sharded": ms / 1e3, "mwm_rounds": want_ms / 1e3},
         equal_to_mwm_rounds=equal)
    if not equal:
        raise AssertionError("mwm_rounds_sharded on a 1x1 mesh differs from mwm_rounds")


def phase_real_graph(config):
    """The main path on the flickr standin (RMAT at flickr's n rounded up to
    a power of two, its m), checked with ``check_matching``."""
    import numpy as np
    import torch

    from repro_torch.core import (
        EdgeStream, SubstreamConfig, check_matching, merge_host, mwm_blocked, mwm_pipeline,
    )
    from repro_torch.graph import PAPER_GRAPHS, real_graph_standin, uniform_weights
    from repro_torch.graph.generators import standin_shape
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import device_plan

    scale, edge_factor = standin_shape(REAL_GRAPH)
    t0 = time.perf_counter()
    src, dst = real_graph_standin(REAL_GRAPH, seed=config.seed)
    w = uniform_weights(src.shape[0], config.L, config.eps, seed=config.seed)
    gen_s = time.perf_counter() - t0
    stream = EdgeStream.from_numpy(src, dst, w)
    cfg = SubstreamConfig(n=1 << scale, L=config.L, eps=config.eps)
    del src, dst, w
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=config.K)
    pipeline_s = time.perf_counter() - t0
    launches = dict(build.launches)
    if launches.get(kernel.NAME, 0) < 1:
        raise AssertionError(f"the main path on {REAL_GRAPH} launched no {kernel.NAME}: {launches}")
    res = mwm_blocked(stream, cfg, K=config.K, backend="kernel")
    if not np.array_equal(merge_host(stream, res, cfg), idx):
        raise AssertionError("the staged run disagrees with mwm_pipeline")
    t0 = time.perf_counter()
    check_matching(res, stream, cfg, merged=idx)
    check_s = time.perf_counter() - t0
    plan = device_plan(cfg.n, cfg.L)
    m = stream.num_edges
    emit("real_graph", graph=REAL_GRAPH, paper_n_m=PAPER_GRAPHS[REAL_GRAPH], scale=scale,
         edge_factor=edge_factor, n=cfg.n, m=m, L=cfg.L, K=config.K,
         bit_block_bytes=plan.nbytes, fits_l2=plan.fits_l2,
         seconds={"generate_host": gen_s, "pipeline": pipeline_s, "check_matching": check_s},
         edges_per_s_pipeline=m / pipeline_s, launches=launches,
         matched_edges=int(idx.size), weight=weight, check_matching="passed")


def phase_substrate(config, stream, cfg):
    """The graph substrate on the card: ``coarsen_by_matching`` on the paper
    stream (timed, counted: it launches the packed per-edge kernel) and at
    COARSEN_CHECK_SCALE equal to the CPU run; ``gseq`` on a prefix, card
    against CPU; the segment ops at SEGMENT_SCALE, card against CPU (the
    maximum exact; atomics reorder the float32 sums, so a sum's error is
    held to SEGMENT_RTOL of the sum of its terms' magnitudes)."""
    import numpy as np
    import torch

    from repro_torch import graph
    from repro_torch.core import gseq
    from repro_torch.core.gseq import gseq_pass
    from repro_torch.core.types import to_numpy
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel

    out = {}
    src, dst, w = (to_numpy(t) for t in (stream.src, stream.dst, stream.weight))
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    mapping, lo, _, _ = graph.coarsen_by_matching(src, dst, w, cfg.n)
    coarsen_s = time.perf_counter() - t0
    launches = dict(build.launches)
    if launches.get(kernel.NAME, 0) != 1:
        raise AssertionError(f"coarsen_by_matching launched {launches}, not one {kernel.NAME}")
    out["coarsen"] = {"scale": config.scale, "m": int(src.size), "seconds": coarsen_s,
                      "launches": launches, "coarse_n": int(mapping.max()) + 1,
                      "coarse_m": int(lo.size)}
    del src, dst, w, mapping, lo
    s, d = graph.kronecker_graph(COARSEN_CHECK_SCALE, config.edge_factor, seed=config.seed)
    ws = graph.uniform_weights(s.size, config.L, config.eps, seed=config.seed)
    card = graph.coarsen_by_matching(s, d, ws, 1 << COARSEN_CHECK_SCALE)
    host = graph.coarsen_by_matching(s, d, ws, 1 << COARSEN_CHECK_SCALE, device="cpu")
    out["coarsen_check"] = {"scale": COARSEN_CHECK_SCALE, "m": int(s.size),
                            "equal_to_cpu": all(np.array_equal(a, b) for a, b in zip(card, host))}
    prefix = _head(stream, 0, GSEQ_PREFIX)
    t0 = time.perf_counter()
    kept = gseq_pass(prefix, cfg.n, cfg.eps)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept_cpu = gseq_pass(prefix.to("cpu"), cfg.n, cfg.eps)
    cpu_s = time.perf_counter() - t0
    matched = gseq(prefix, cfg.n, cfg.eps)
    out["gseq"] = {"m": GSEQ_PREFIX, "pass_seconds": {"card": card_s, "cpu": cpu_s},
                   "pushed": int(kept_cpu.sum()), "matched_edges": int(matched.size),
                   "equal_to_cpu": bool(torch.equal(kept.cpu(), kept_cpu)) and np.array_equal(
                       matched, gseq(prefix.to("cpu"), cfg.n, cfg.eps, device="cpu"))}
    s, d = graph.kronecker_graph(SEGMENT_SCALE, config.edge_factor, seed=config.seed)
    n = 1 << SEGMENT_SCALE
    rng = np.random.default_rng(config.seed)
    feats = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    scores = torch.from_numpy(rng.normal(size=s.size).astype(np.float32))
    s, d = torch.from_numpy(s), torch.from_numpy(d)
    on_card = [t.cuda() for t in (feats, scores, s, d)]
    seg = {}
    for reduce in ("sum", "mean", "max"):
        ms, got = cuda_ms(lambda: graph.scatter_messages(on_card[0], on_card[2], on_card[3], n,
                                                         reduce=reduce))
        want = graph.scatter_messages(feats, s, d, n, reduce=reduce)
        if reduce == "max":  # order-free: exact, -inf where a vertex receives nothing
            seg[reduce] = {"ms": ms, "equal": bool(torch.equal(got.cpu(), want))}
            continue
        # atomics reorder the float32 sums: |error| <= rtol * (sum of |terms|)
        size = graph.scatter_messages(feats.abs(), s, d, n, reduce=reduce)
        err = float(((got.cpu() - want).abs() / size.clamp_min(1e-30)).max())
        seg[reduce] = {"ms": ms, "max_err_over_abs_sum": err, "close": err <= SEGMENT_RTOL}
    ms, got = cuda_ms(lambda: graph.segment_softmax(on_card[1], on_card[3], n))
    want = graph.segment_softmax(scores, d, n)
    err = float(((got.cpu() - want).abs() / want.abs().clamp_min(1e-30)).max())
    seg["softmax"] = {"ms": ms, "max_rel_err": err, "close": err <= SEGMENT_RTOL}
    seg["degrees_equal"] = bool(torch.equal(graph.degrees(on_card[2], on_card[3], n).cpu(),
                                            graph.degrees(s, d, n)))
    out["segment"] = {"scale": SEGMENT_SCALE, "m": int(s.numel()), "features": 16, "ops": seg}
    emit("substrate", **out)
    bad = [k for k in ("coarsen_check", "gseq") if not out[k]["equal_to_cpu"]]
    bad += [k for k, v in seg.items() if k != "degrees_equal" and not v.get("close", v.get("equal"))]
    if bad or not seg["degrees_equal"]:
        raise AssertionError(f"the substrate on the card differs from the CPU: {bad}")
    return launches[kernel.NAME]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels.substream_match import kernel

    device, smi = phase_device()
    phase_build()
    config, stream, cfg, gen_s, h2d_s = paper_stream()
    max_err, timed = phase_kernel_vs_plain(stream, cfg, config.K)
    wave_checks = phase_wave_kernels_vs_plain(stream, cfg)
    main = phase_main_path(config, stream, cfg, gen_s, h2d_s)
    wave, sch, mega_result = phase_wave_path(config, stream, cfg)
    unpacked_checks = phase_unpacked_kernels_vs_plain(stream, cfg, config.K)
    unpacked = phase_unpacked_main_path(config, stream, cfg, main)
    unpacked_wave = phase_unpacked_wave_path(config, stream, cfg, sch, mega_result)
    del sch, mega_result
    epoch_full = phase_epoch_path(cfg, unpacked)
    phase_epoch_snapshots(cfg, unpacked, epoch_full)
    del unpacked["blocked"], unpacked["one_shot"]
    merge = phase_merge_device(stream, cfg, main)
    phase_main_telemetry(config, stream, cfg, main)
    del main["result"]
    phase_validate(stream, cfg)
    phase_rounds_path(config, stream, cfg, main)
    coarsen_launches = phase_substrate(config, stream, cfg)
    del stream
    phase_blocked_wave_route(config.K)
    phase_fallback()
    phase_rounds_sharded(config)
    phase_real_graph(config)
    source = "src/repro_torch/kernels/substream_match/csrc/"
    rows = [{
        "name": kernel.NAME,
        "route": "cuda",
        "source": source + "substream_match_edges.cu",
        "replaces": "src/repro/kernels/substream_match/kernel.py:117",
        "launches": main["launches"],
        "max_abs_err": max(max_err, merge["max_abs_err"]),
        "ms": main["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "m": main["m"],
        "plain_m": PLAIN_PREFIX,
        "ms_at_plain_m": timed["ms_at_plain_m"],
        "bound_ms_at_plain_m": timed["bound_ms_at_plain_m"],
        "matched_plain": max_err == 0 and merge["max_abs_err"] == 0,
        "launches_merge_device": merge["launches"],
        "merge_device_recorded_edges": merge["recorded_edges"],
        "merge_device_ms_L1": merge["ms"],
        "launches_coarsen_by_matching": coarsen_launches,
    }]
    for name, line in ((kernel.MEGA_NAME, 519), (kernel.WAVES_NAME, 243)):
        err, t = wave_checks[name]
        w = wave[name]
        rows.append({
            "name": name, "route": "cuda", "source": source + "substream_match_waves.cu",
            "replaces": f"src/repro/kernels/substream_match/kernel.py:{line}",
            "launches": w["launches"], "max_abs_err": err, "ms": w["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "library_ms": None, "m": w["m"], "slot_fill": w["slot_fill"],
            "us_per_wave": w["us_per_wave"],
            "plain_m": WAVE_PLAIN_PREFIX, "ms_at_plain_m": t["ms_at_plain_m"],
            "bound_ms_at_plain_m": t["bound_ms_at_plain_m"], "matched_plain": err == 0,
        })
    for name, line, path in ((kernel.UNPACKED_NAME, 74, unpacked),
                             (kernel.MEGA_UNPACKED_NAME, 451, unpacked_wave[kernel.MEGA_UNPACKED_NAME]),
                             (kernel.WAVES_UNPACKED_NAME, 168, unpacked_wave[kernel.WAVES_UNPACKED_NAME])):
        err, t = unpacked_checks[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": source + ("substream_match_edges.cu" if name == kernel.UNPACKED_NAME
                                else "substream_match_waves.cu"),
            "replaces": f"src/repro/kernels/substream_match/kernel.py:{line}",
            "launches": path["launches"], "max_abs_err": err, "ms": path["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": None, "m": path["m"], "fits_l2": path["fits_l2"],
            **({k: path[k] for k in ("slot_fill", "us_per_wave") if k in path}),
            "plain_m": t["plain_m"], "ms_at_plain_m": t["ms_at_plain_m"],
            "bound_ms_at_plain_m": t["bound_ms_at_plain_m"], "matched_plain": err == 0,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
