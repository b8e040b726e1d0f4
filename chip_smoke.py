#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's main path from the sources in the
checkout, holds each against its plain PyTorch version on the card, then
drives the paper's main path (Kronecker scale 20, edge factor 48, L=64,
eps=0.1, K=32: blocked order -> packed per-edge kernel -> greedy merge)
through ``mwm_pipeline(part1="kernel")`` and checks the matching with the
postcondition guard. Each phase prints one JSON line; any failure raises,
so the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""
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
#: edges of the blocked paper stream on which the kernel meets its plain version
PLAIN_PREFIX = 20_000


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


def bound(m, n_pad, width):
    """(bound_ms, bound_by) of Part 1 on m edges from zero bits: each input
    read once and each output written once (edge pair, weight, assigned,
    the bit block), or the float32 threshold compares."""
    nbytes = m * 16 + n_pad * width
    ops = m * 8 * width
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel

    kernel._launcher()
    info = build.builds[kernel.NAME]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", info["ptxas"])]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info["ptxas"])]
    emit("build", kernel=kernel.NAME, seconds=info["seconds"], built=info["built"],
         registers=regs, spill_bytes=spills)
    if not info["built"] or not regs:
        raise RuntimeError("the kernel was not built from the checkout's source")


def paper_stream():
    """The paper's configuration, generated on the host and moved to the card."""
    import torch

    from repro_torch.configs.paper_matching import CONFIG
    from repro_torch.core import EdgeStream, SubstreamConfig
    from repro_torch.graph.generators import kronecker_graph, uniform_weights

    t0 = time.perf_counter()
    src, dst = kronecker_graph(CONFIG.scale, CONFIG.edge_factor, seed=CONFIG.seed)
    w = uniform_weights(src.shape[0], CONFIG.L, CONFIG.eps, seed=CONFIG.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = EdgeStream.from_numpy(src, dst, w)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    cfg = SubstreamConfig(n=1 << CONFIG.scale, L=CONFIG.L, eps=CONFIG.eps)
    return CONFIG, stream, cfg, gen_s, h2d_s


def phase_kernel_vs_plain(paper, paper_cfg, K):
    """Every case through the kernel and its plain version on the same
    operands on the card; assigned and the bit block must be equal."""
    import torch

    from repro_torch.core import EdgeStream, SubstreamConfig, lexicographic_order, permute_stream
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.kernels.substream_match.ops import kernel_inputs, substream_match
    from repro_torch.testing.cases import ZOO, rmat_case

    def on_card(case, mb0=None):
        stream = EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad)
        return stream, SubstreamConfig(n=case.n, L=case.L, eps=case.eps), mb0

    def head(stream, lo, hi):
        return permute_stream(stream, torch.arange(lo, hi, device=stream.device))

    cases = {f"zoo_{name}": on_card(fn()) for name, fn in ZOO.items()}
    for L, eps in ((13, 0.1), (64, 0.1), (300, 0.01)):
        cases[f"rmat12_L{L}"] = on_card(rmat_case(12, edge_factor=4, L=L, eps=eps, pad=5))
    # carried state: the second half of a stream, seeded with the first half's bits
    stream, cfg, _ = on_card(rmat_case(12, edge_factor=4, L=64))
    h = stream.num_edges // 2
    mb0 = substream_match(head(stream, 0, h), cfg).mb_packed
    cases["rmat12_L64_mb0"] = (head(stream, h, stream.num_edges), cfg, mb0)
    blocked = permute_stream(paper, lexicographic_order(paper, K))
    cases["paper_blocked_prefix"] = (head(blocked, 0, PLAIN_PREFIX), paper_cfg, None)

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
         ns_per_edge_kernel=kernel_ms * 1e6 / m,
         launches=launches, max_memory_allocated=peak,
         recorded_edges=recorded, matched_edges=int(idx.size), weight=weight,
         check_matching="passed")
    return {"m": m, "ms": kernel_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": launches[kernel.NAME]}


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
    main = phase_main_path(config, stream, cfg, gen_s, h2d_s)
    print(json.dumps({"kernels": [{
        "name": kernel.NAME,
        "route": "cuda",
        "source": "src/repro_torch/kernels/substream_match/csrc/substream_match_packed.cu",
        "replaces": "src/repro/kernels/substream_match/kernel.py:117",
        "launches": main["launches"],
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "m": main["m"],
        "plain_m": PLAIN_PREFIX,
        "ms_at_plain_m": timed["ms_at_plain_m"],
        "bound_ms_at_plain_m": timed["bound_ms_at_plain_m"],
        "matched_plain": max_err == 0,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
