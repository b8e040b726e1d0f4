#!/usr/bin/env python3
"""Build and kernel table of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds both CUDA libraries of the port from the sources in the checkout
(one nvcc per source, all at once; no entry may spill registers), then
holds each hand-written kernel to its plain PyTorch version on the card and
times it on the paper's configuration (Kronecker scale 20, edge factor 48,
L=64, eps=0.1, K=32):

* the walker (row 1) and the rounds engine (row 1r) on the zoo, the
  streams aimed at the per-edge kernels' batch window, RMAT at several L,
  carried bits and the blocked paper prefix; the rounds engine also against
  the walker on the whole blocked paper stream, in the allocator's slices
  and in slices of two chunks, at L 13 and from carried bits;
* the two packed wave kernels (rows 2, 3) and the three unpacked kernels
  (rows 4-6) on the zoo, RMAT, carried bits, each seg_block, the paper
  prefixes and the streams aimed at their slot ring;
* the paths that carry the seven rows at full size: the main path
  (``mwm_pipeline(part1="kernel")``: Part 1 on the rounds engine, the merge
  on the walker at L = 1) and its stages timed, the wave path on the
  generated order (``schedule="mega"`` and ``"waves"``, bit-equal to the
  walker on that order), the unpacked main and wave paths (bit-equal to
  their packed twins), and ``merge_device`` against ``merge_host`` with its
  L = 1 launch timed and held to its plain version.

Each path runs with the launch counts set to 0 just before it and read just
after; a path that launched none of its kernel raises, and the counts are
printed: what exactly they must be is the card tests' decision
(``tests/test_torch_gpu.py``). Each phase prints one JSON line; a
kernel that differs from its plain version raises, so the script exits
non-zero. Then ``{"kernels": [...]}``, one row per kernel (PERF.md's kernel
table), and last ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 1 and prints no result.
"""
import concurrent.futures
import functools
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.roofline import HBM_BW  # noqa: E402

#: H100 SXM peak (NVIDIA data sheet): float32 outside the tensor cores
F32_OPS_PER_S = 67e12
#: edges of the blocked paper stream on which the per-edge kernel meets its plain version
PLAIN_PREFIX = 20_000
#: device bytes an edge of the rounds engine's grouping moves at least (bound_rounds)
ROUNDS_GROUPING_BYTES = 8 + 8 + 24 + 24
#: edges of the generated paper stream on which the wave kernels meet theirs
WAVE_PLAIN_PREFIX = 200_000



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
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_rounds(m, n_pad, width):
    """(bound_ms, bound_by) of the rounds engine on m edges: :func:`bound`'s
    bytes plus the grouping's, each once: the int32 keys written and read
    by the sort (8 B an edge each), the sorted keys and int64 indices the
    sort writes and the engine reads (24 B an edge each)."""
    t_bytes = (m * (16 + ROUNDS_GROUPING_BYTES) + n_pad * width) / HBM_BW * 1e3
    t_ops = m * 8 * width / F32_OPS_PER_S * 1e3
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


def paper_stream():
    """The paper's configuration, generated on the host in its generated
    order and moved to the card."""
    import torch

    from repro_torch.configs.paper_matching import CONFIG as config
    from repro_torch.core import EdgeStream, SubstreamConfig
    from repro_torch.graph.generators import kronecker_graph, uniform_weights

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


def _edge_cases(paper, paper_cfg, K):
    """{name: (stream, cfg, mb0)} on the card for the per-edge engines: the
    zoo, the window cases, RMAT at L 13, 64, 300 and 2048, carried bits
    (also at L 2048), and the blocked paper prefix."""
    from repro_torch.core import lexicographic_order, permute_stream
    from repro_torch.kernels.substream_match.ops import substream_match
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
    return cases


def phase_kernel_vs_plain(paper, paper_cfg, K):
    """Every case of :func:`_edge_cases` through the walker (row 1) and its
    plain version on the same operands on the card; assigned and the bit
    block must be equal."""
    import torch

    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import kernel_inputs

    results, max_err, timed = {}, 0, {}
    for name, (stream, cfg, mb0) in _edge_cases(paper, paper_cfg, K).items():
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


def _launched(before):
    """The launch counts added since ``before`` (a copy of ``build.launches``)."""
    from repro_torch.kernels import build

    return {k: v - before.get(k, 0) for k, v in build.launches.items() if v != before.get(k, 0)}


def phase_rounds_engine(paper, paper_cfg, K):
    """The rounds engine (the main path's Part 1 at L <= 64) bit for bit on
    the card: against its plain version (row 1's) on every case of
    :func:`_edge_cases` with L <= 64, the blocked paper prefix among them;
    then against the walker (row 1) on the whole blocked paper stream, in
    slices as the allocator's room gives them and in the floor's slices of
    two chunks (a budget of 0), at L 13, and its second half from the first
    half's bits. Each call launches one keys and one rounds kernel a slice.
    Times both engines on the whole stream (CUDA events) and the rounds
    engine at the prefix."""
    import torch

    from repro_torch.core import SubstreamConfig, lexicographic_order, permute_stream
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import kernel_inputs

    def held(label, args, want, budget=None):
        before, saved = dict(build.launches), kernel.group_budget
        if budget is not None:
            kernel.group_budget = lambda device: budget
        try:
            stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
            a, mb = kernel.substream_match_rounds(*args, stats=stats)
            torch.cuda.synchronize()
        finally:
            kernel.group_budget = saved
        launched = _launched(before)
        slices = launched.get(kernel.ROUNDS_NAME, 0)
        err = _compare(a, mb, *want)
        chunks, rounds = stats.tolist()
        results[label] = {"m": int(args[0].shape[0]), "L": 8 * args[2].shape[1],
                          "equal": err == 0, "slices": slices, "chunks": chunks,
                          "rounds": rounds, "launches": launched}
        if err or launched != ({kernel.ROUNDS_NAME: slices, kernel.ROUNDS_KEYS_NAME: slices}
                               if args[0].shape[0] else {}):
            bad.append(label)
        return err

    results, bad, timed, max_err = {}, [], {}, 0
    for name, (stream, cfg, mb0) in _edge_cases(paper, paper_cfg, K).items():
        if cfg.L > 64:
            continue
        args = kernel_inputs(stream, cfg, mb0)
        max_err = max(max_err, held(name, args, kernel.substream_match_packed_plain(*args)))
        if name == "paper_blocked_prefix":
            timed["ms_at_plain_m"], _ = cuda_ms(lambda: kernel.substream_match_rounds(*args),
                                                reps=5)
            timed["bound_ms_at_plain_m"] = bound_rounds(stream.num_edges, args[3],
                                                        args[2].shape[1])[0]
    blocked = permute_stream(paper, lexicographic_order(paper, K))
    args = kernel_inputs(blocked, paper_cfg)
    walker_ms, want = cuda_ms(lambda: kernel.substream_match_packed(*args))
    max_err = max(max_err, held("paper_blocked", args, want),
                  held("paper_blocked_floor_slices", args, want, budget=0))
    timed["ms"], _ = cuda_ms(lambda: kernel.substream_match_rounds(*args), reps=5)
    timed["walker_ms"] = walker_ms
    timed["walker_bound_ms"], timed["walker_bound_by"] = bound(blocked.num_edges, args[3],
                                                               args[2].shape[1])
    h = blocked.num_edges // 2
    head = kernel.substream_match_packed(args[0][:h], args[1][:h], *args[2:])
    tail = (args[0][h:], args[1][h:], args[2], args[3], head[1])
    max_err = max(max_err, held("paper_blocked_mb0", tail, kernel.substream_match_packed(*tail)))
    del head, tail
    args13 = kernel_inputs(blocked, SubstreamConfig(n=paper_cfg.n, L=13, eps=paper_cfg.eps))
    max_err = max(max_err, held("paper_blocked_L13", args13,
                                kernel.substream_match_packed(*args13)))
    emit("rounds_engine", kernel=kernel.ROUNDS_NAME, cases=results, max_abs_err=max_err,
         plain_m=PLAIN_PREFIX, blocked_m=blocked.num_edges, **timed)
    if bad:
        raise AssertionError(f"the rounds engine differs or miscounts on {bad}")
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
    """The main path once through the public entry point, counted (Part 1's
    rounds engine and the merge's walker launch); then the same calls stage
    by stage, timed, and the result checked."""
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
    slices = launches.get(kernel.ROUNDS_NAME, 0)
    if slices < 1:
        raise AssertionError(f"the main path launched no {kernel.ROUNDS_NAME}: {launches}")

    def sort():
        order = lexicographic_order(stream, config.K)
        return order, permute_stream(stream, order)

    sort_ms, (order, blocked) = cuda_ms(sort)
    args = kernel_inputs(blocked, cfg)
    shares = window_share(args[0])
    kernel_runs = []
    for _ in range(3):
        ms, (a_blk, mb) = cuda_ms(lambda: kernel.substream_match_rounds(*args))
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
    bound_ms, bound_by = bound_rounds(m, plan.n_pad, plan.width)
    emit("main_path", config=config.name, scale=config.scale, edge_factor=config.edge_factor,
         L=cfg.L, eps=cfg.eps, K=config.K, n=cfg.n, m=m,
         bit_block_bytes=plan.nbytes, fits_l2=plan.fits_l2,
         seconds={"generate_host": gen_s, "from_numpy_h2d": h2d_s, "pipeline": pipeline_s,
                  "sort_permute": sort_ms / 1e3, "kernel": kernel_ms / 1e3,
                  "kernel_runs": [t / 1e3 for t in kernel_runs],
                  "merge_host": merge_s, "check_matching": check_s},
         edges_per_s_pipeline=m / pipeline_s, edges_per_s_part1_kernel=m / (kernel_ms / 1e3),
         ns_per_edge_kernel=kernel_ms * 1e6 / m, kernel=kernel.ROUNDS_NAME, window_share=shares,
         launches=launches, part1_slices=slices, max_memory_allocated=peak,
         recorded_edges=recorded, matched_edges=int(idx.size), weight=weight,
         check_matching="passed")
    return {"m": m, "ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": slices, "keys_launches": launches.get(kernel.ROUNDS_KEYS_NAME, 0),
            "merge_launches": launches.get(kernel.NAME, 0), "result": result, "idx": idx,
            "weight": weight, "merge_host_s": merge_s}


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
    path's. Returns the kernel's row."""
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
            "fits_l2": plan.fits_l2}


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
    rounds_err, rounds_timed = phase_rounds_engine(stream, cfg, config.K)
    wave_checks = phase_wave_kernels_vs_plain(stream, cfg)
    main = phase_main_path(config, stream, cfg, gen_s, h2d_s)
    wave, sch, mega_result = phase_wave_path(config, stream, cfg)
    unpacked_checks = phase_unpacked_kernels_vs_plain(stream, cfg, config.K)
    unpacked = phase_unpacked_main_path(config, stream, cfg, main)
    unpacked_wave = phase_unpacked_wave_path(config, stream, cfg, sch, mega_result)
    del sch, mega_result
    merge = phase_merge_device(stream, cfg, main)
    source = "src/repro_torch/kernels/substream_match/csrc/"
    rows = [{
        "name": kernel.NAME,
        "route": "cuda",
        "source": source + "substream_match_edges.cu",
        "replaces": "src/repro/kernels/substream_match/kernel.py:117",
        # on the main path the merge's L = 1 launch alone; ms: the whole
        # blocked paper stream at L = 64, no longer the main path's Part 1
        "launches": main["merge_launches"],
        "max_abs_err": max(max_err, merge["max_abs_err"]),
        "ms": rounds_timed["walker_ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": rounds_timed["walker_bound_ms"],
        "bound_by": rounds_timed["walker_bound_by"],
        "library_ms": None,
        "m": main["m"],
        "plain_m": PLAIN_PREFIX,
        "ms_at_plain_m": timed["ms_at_plain_m"],
        "bound_ms_at_plain_m": timed["bound_ms_at_plain_m"],
        "matched_plain": max_err == 0 and merge["max_abs_err"] == 0,
        "launches_merge_device": merge["launches"],
        "merge_device_recorded_edges": merge["recorded_edges"],
        "merge_device_ms_L1": merge["ms"],
    }, {
        "name": kernel.ROUNDS_NAME,
        "route": "cuda",
        "source": source + "substream_match_edges.cu",
        "replaces": None,  # row 1's function at L <= 64: the main path's Part 1
        "launches": main["launches"],
        "launches_keys": main["keys_launches"],
        "max_abs_err": rounds_err,
        "ms": main["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "library_call": "torch.sort (stable, int32 keys), once a slice",
        "m": main["m"],
        "plain_m": PLAIN_PREFIX,
        "ms_at_plain_m": rounds_timed["ms_at_plain_m"],
        "bound_ms_at_plain_m": rounds_timed["bound_ms_at_plain_m"],
        "matched_plain": rounds_err == 0,
        "ms_whole_stream_apart": rounds_timed["ms"],
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
