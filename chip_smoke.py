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
  (through the per-edge engine, counted: one call) and at scale 12 equal to
  the CPU run, ``gseq`` on a 20,000-edge prefix and the segment ops at
  scale 16, card against CPU; the main path on the flickr standin
  (``real_graph_standin``: n = 2^22, about 33 M edges), checked;
* the GNN training path: the sampled GIN trainer on the paper graph
  (``coarsen_by_matching`` through the per-edge engine, counted,
  then sampled batches at the minibatch_lg dimensions, GIN at gin-tu's
  width, 5 AdamW steps, step 1 held to the CPU); GIN at gin-tu's width on
  the ogb_products dimensions (3 steps, ms per step, peak memory); EGNN,
  MeshGraphNet and Equiformer-v2 at their published widths on the
  molecule shape, one step each held to the CPU (Equiformer-v2 at 3 of its
  12 layers there, its 12-layer step timed on the card);
* the serving paths: gemma-7b at its published config (28 layers, bf16
  weights) prefilling two 32,768-token requests and decoding 32 greedy
  steps into one cache, decode step 1 held to ``backbone`` on 32,769
  tokens; gemma-7b, internlm2-20b, minicpm-2b and moonshot-v1-16b-a3b at
  their published widths cut to 2 layers, float32, held to the CPU;
  BERT4Rec at its published config on serve_p99, serve_bulk and
  retrieval_cand, a serve_p99 batch held to the CPU; serve_bulk also with
  ``torch.topk``'s two stages (any index among ties) in turns with the
  tie-exact top-k;
* the training paths (run first, on an empty card): minicpm-2b at its
  published config (40 layers, bf16 weights, float32 moments) on
  train_4k's 4,096-token sequences, its batch cut to what one card holds,
  3 ``make_lm_train_step`` steps with the WSD
  schedule (ms, tokens/s, peak, model-FLOP share); minicpm-2b and
  moonshot-v1-16b-a3b (two router columns tied) at their published widths
  cut to 2 and 1 layers, float32, one train step on the card held to the CPU;
  BERT4Rec at its published config on train_batch, its users cut, 3
  ``make_recsys_step`` train steps, one step of 64 users held to the CPU.
  The serving and training phases launch none of the six kernels
  (attention, MoE dispatch, the losses and AdamW are plain PyTorch, as they
  are plain XLA in the reference);
* sharded execution (after the training phases): gemma-7b at its
  published width cut to 2 layers, float32, 5 ``make_lm_train_step`` steps
  on a 1x1 NCCL mesh with every parameter a DTensor under the JAX
  package's multi-device test's rules, then the same steps without a
  mesh: losses equal, ms a step and peak of each (a larger world needs a
  card per rank; the multi-rank checks are the CPU tests);
* the two matching examples at their defaults (``launch/quickstart.py``,
  ``launch/matching_e2e.py``): the packed per-edge kernel counted in each,
  the exact MWM ratio at most 4 + eps;
* the dry-run tooling (``launch/dryrun.py``; a subprocess of its own, after
  the sharded phase): its model of the sharded phase's step on a 1x1 world
  held to what that phase measured (peak within 0.8-1.25x, the step's
  lower bound at most the measured step) and to ``FlopCounterMode`` over one
  step on the card (1 %), then one production cell per family on a fake
  world of 256 ranks and one of 512 (``meta`` tensors; no launch).

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
#: device bytes an edge of the rounds engine's grouping moves at least (bound_rounds)
ROUNDS_GROUPING_BYTES = 8 + 8 + 24 + 24
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
#: AdamW steps of the sampled GIN trainer on the paper graph, and of GIN at
#: the ogb_products dimensions
GNN_SAMPLED_STEPS = 5
GNN_FULL_STEPS = 3
#: a GNN step on the card against the CPU: the loss's relative error, and each
#: gradient's largest error over its largest magnitude, or over 1e-3 where that
#: is smaller (``grad_errors``; atomics reorder the sums)
GNN_LOSS_RTOL = 1e-4
GNN_GRAD_RTOL = 1e-3
#: the depth at which Equiformer-v2's molecule step is held to the CPU
EQV2_HELD_LAYERS = 3
#: bf16 peak of the tensor cores (dense), for the LM's bounds
BF16_OPS_PER_S = 989e12
#: LM serving (gemma-7b at its published config): requests, the cache's slots,
#: greedy decode steps; decode step 1 against ``backbone`` (error over the largest
#: logit), and the full-width 2-layer models on the card against the CPU
LM_BATCH = 2
LM_MAX_LEN = 32_800
LM_DECODE_STEPS = 32
LM_DECODE_RTOL = 3e-2
LM_HELD_ARCHS = ("gemma-7b", "internlm2-20b", "minicpm-2b", "moonshot-v1-16b-a3b")
LM_HELD_LAYERS = 2
LM_HELD_PROMPT = 256
LM_HELD_STEPS = 4
LM_HELD_RTOL = 1e-4
#: LM training: minicpm-2b at its published config on train_4k, the sequences a
#: step (train_4k's 256, cut to what one card holds beside the 36.1 GB of
#: weights, gradients and float32 moments) and the steps; the 2-layer
#: full-width models whose train step is held to the CPU, on 2 x 128 tokens
LM_TRAIN_ARCH = "minicpm-2b"
LM_TRAIN_BATCH = 5
LM_TRAIN_STEPS = 3
#: the archs held to the CPU in one train step, and the layers each keeps:
#: moonshot's CPU step (64 experts a layer) is cut to one layer to keep the
#: smoke inside its time
LM_TRAIN_HELD_LAYERS = {"minicpm-2b": 2, "moonshot-v1-16b-a3b": 1}
LM_TRAIN_HELD_TOKENS = 128
#: BERT4Rec training at its published config: users a step (train_batch's 65,536
#: cut: its [B, 40, 8,193] float32 logits are 86 GB at 65,536), steps, and the
#: users of the step held to the CPU
RECSYS_TRAIN_BATCH = 6144
RECSYS_TRAIN_STEPS = 3
RECSYS_HELD_USERS = 64
#: BERT4Rec serving: serve_p99 batches timed, and a serve_p99 batch's scores on the
#: card against the CPU (error over the largest magnitude)
RECSYS_P99_BATCHES = 20
RECSYS_RTOL = 1e-5
#: sharded LM training: gemma-7b at its published width cut to 2 of its 28
#: layers (float32 weights and AdamW state of 28 layers are ~136 GB), float32,
#: under the rules of the JAX package's multi-device test on a 1x1 NCCL mesh,
#: sequences x tokens a step, steps, the rate, and the sharded run's losses
#: against the same steps without a mesh (relative)
SHARDED_ARCH = "gemma-7b"
SHARDED_LAYERS = 2
SHARDED_BATCH = 4
SHARDED_TOKENS = 1024
SHARDED_STEPS = 5
SHARDED_LR = 1e-3
SHARDED_RULES = {"dp": ("data",), "embed": None, "heads": "model", "kv_heads": "model",
                 "mlp": "model", "vocab": "model", "layers": None, "model_seq": None}
SHARDED_LOSS_RTOL = 1e-5
#: the dry-run phase (a subprocess of its own: its fake world of 256 or 512
#: ranks never shares a process with an NCCL group): the calibration on
#: sharded_lm_train's configuration, then one production cell per family on
#: the fake 16x16 world and one on 2x16x16 (arch, shape, multi_pod)
DRYRUN_CELLS = (("gemma-7b", "train_4k", False), ("gin-tu", "ogb_products", False),
                ("bert4rec", "serve_p99", False), ("minicpm-2b", "train_4k", True))
DRYRUN_TIMEOUT_S = 150


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


def bound_rounds(m, n_pad, width):
    """(bound_ms, bound_by) of the rounds engine on m edges: :func:`bound`'s
    bytes plus the grouping's, each once: the int32 keys written and read
    by the sort (8 B an edge each), the sorted keys and int64 indices the
    sort writes and the engine reads (24 B an edge each)."""
    t_bytes = (m * (16 + ROUNDS_GROUPING_BYTES) + n_pad * width) / HBM_BYTES_PER_S * 1e3
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


def _main_path_launches(launches, label):
    """Part 1 of the main path on the rounds engine (a keys and a rounds
    launch a slice) and the merge's one walker launch (row 1 at L = 1),
    nothing else. Returns the slices."""
    from repro_torch.kernels.substream_match import kernel

    slices = launches.get(kernel.ROUNDS_NAME, 0)
    if slices < 1 or launches != {kernel.ROUNDS_NAME: slices, kernel.ROUNDS_KEYS_NAME: slices,
                                  kernel.NAME: 1}:
        raise AssertionError(f"{label}: Part 1 not on the rounds engine or the merge not one "
                             f"{kernel.NAME} launch: {launches}")
    return slices


def phase_main_path(config, stream, cfg, gen_s, h2d_s):
    """The main path once through the public entry point, counted (Part 1
    on the rounds engine, the merge's walker launch apart); then the same
    calls stage by stage, timed, and the result checked."""
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
    slices = _main_path_launches(launches, "the main path")

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
            "launches": slices, "keys_launches": launches[kernel.ROUNDS_KEYS_NAME],
            "merge_launches": launches[kernel.NAME], "result": result, "idx": idx,
            "weight": weight,
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
    one ``kernel_edges`` record whose stage split holds together, and the
    pipeline's time beside the main path's (telemetry off)."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import mwm_pipeline
    from repro_torch.kernels import build

    tel = obs.Telemetry()
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=config.K, telemetry=tel)
    pipeline_s = time.perf_counter() - t0
    launches = dict(build.launches)
    _main_path_launches(launches, "the telemetry run")
    routes = {k: tel.counters.get(f"kernel_edges.{k}.calls") for k in ("rounds_engine", "walker")}
    if routes != {"rounds_engine": 1, "walker": 0} or tel.counters.get("kernel_edges.chunks") < 1:
        raise AssertionError(f"the telemetry run's route counters: {routes}")
    if not (np.array_equal(idx, main["idx"]) and weight == main["weight"]):
        raise AssertionError("the main path with telemetry differs from the one without")
    rec, = tel.match_calls
    problems = obs.consistency_problems(rec.stage_seconds, rec.wall_seconds)
    emit("main_path_telemetry", record=rec.asdict(),
         consistency_problems=problems, events=tel.events,
         pipeline_seconds={"telemetry_on": pipeline_s, "telemetry_off": main["pipeline_s"]},
         launches=launches, routes=routes,
         chunks=tel.counters.get("kernel_edges.chunks"),
         rounds=tel.counters.get("kernel_edges.rounds"))
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
        runs = {  # schedule, injection, fallback events, outcome, launches (or their check)
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
            "edges_clean": ("edges", contextlib.nullcontext(), 0, "equal",
                            _one_edges_call if packed else {edges_k: 1}),
            "edges_exhausted": ("edges", refused("edges_device"), 1, "exhausted: edges", {}),
        }
        for label, (schedule, inject, n_events, outcome, launches) in runs.items():
            out = ladder(stream, cfg, want, schedule, packed, inject,
                         waves=None if schedule == "edges" else sch)
            results[f"scale16_{layout}_{label}"] = out
            launched_ok = (launches(out["launches"]) if callable(launches)
                           else out["launches"] == launches)
            if (out["outcome"] != outcome or out["fallback_count"] != n_events
                    or not launched_ok or {"waves_xla", "scan"} & set(out["records"])):
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
    _main_path_launches(launches, f"the main path on {REAL_GRAPH}")
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
    stream (timed, counted: one call of the per-edge engine) and at
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

    out = {}
    src, dst, w = (to_numpy(t) for t in (stream.src, stream.dst, stream.weight))
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    mapping, lo, _, _ = graph.coarsen_by_matching(src, dst, w, cfg.n)
    coarsen_s = time.perf_counter() - t0
    launches = dict(build.launches)
    if not _one_edges_call(launches):
        raise AssertionError(f"coarsen_by_matching launched {launches}, not one per-edge call")
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
    return sum(launches.values())


def _one_edges_call(launches: dict) -> bool:
    """One packed Part-1 call at L <= 64 on the card, as ``ops.edges_route``
    sends it: the rounds engine's launches, one keys and one rounds launch
    a slice, and nothing else."""
    from repro_torch.kernels.substream_match import kernel

    slices = launches.get(kernel.ROUNDS_NAME, 0)
    return slices >= 1 and launches == {kernel.ROUNDS_NAME: slices,
                                        kernel.ROUNDS_KEYS_NAME: slices}


def _held_to_cpu(label, model, batch, step):
    """``step()`` on the card (host clock around it, synchronized), its loss
    and gradients held to the same weights on the CPU for ``batch``."""
    import torch

    from repro_torch.testing.gnn_check import cpu_loss_and_grads, grad_errors

    t0 = time.perf_counter()
    loss_cpu, grads_cpu = cpu_loss_and_grads(model, batch)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step()
    loss = float(out["loss"])
    card_s = time.perf_counter() - t0
    errs = grad_errors(model, grads_cpu)
    worst = max(errs, key=errs.get)
    check = {"loss": loss, "loss_cpu": loss_cpu, "loss_rel_err": abs(loss - loss_cpu) / abs(loss_cpu),
             "grad_err_over_max": errs[worst], "worst_grad": worst,
             "grad_norm": float(out["grad_norm"]), "seconds": card_s, "cpu_seconds": cpu_s}
    if not (check["loss_rel_err"] <= GNN_LOSS_RTOL and errs[worst] <= GNN_GRAD_RTOL):
        raise AssertionError(f"{label}: the step on the card differs from the CPU: {check}")
    return check


def phase_gnn_sampled(config, stream, cfg):
    """GIN at gin-tu's width trained on sampled batches of the paper graph
    (the generated stream, symmetrized) at the minibatch_lg dimensions:
    ``coarsen_by_matching`` (one call of the per-edge engine), the
    CSR, the sampler (1,024 seeds, fanouts 15-10), then GNN_SAMPLED_STEPS
    AdamW steps; step 1's loss and gradients held to the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import sampled_subgraph_sizes
    from repro_torch.core.types import to_numpy
    from repro_torch.kernels import build
    from repro_torch.launch.gnn_train import SampledGINTrainer
    from repro_torch.launch.steps import gnn_shape_config

    arch = get_arch("gin-tu")
    shape = arch.shapes["minibatch_lg"]
    gcfg = gnn_shape_config(arch, shape)
    n_pad, e_pad = sampled_subgraph_sizes(shape)
    src, dst, w = (to_numpy(t) for t in (stream.src, stream.dst, stream.weight))
    torch.cuda.synchronize()
    build.launches.clear()
    t0 = time.perf_counter()
    trainer = SampledGINTrainer(src, dst, w, cfg.n, gcfg, fanouts=shape.fanouts,
                                n_seeds=shape.batch_nodes, n_pad=n_pad, e_pad=e_pad)
    setup_s = time.perf_counter() - t0
    del src, dst, w
    steps = []
    for i in range(GNN_SAMPLED_STEPS):
        t0 = time.perf_counter()
        batch, nn, ne = trainer.next_batch()
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        if i == 0:
            check = _held_to_cpu("gnn_sampled", trainer.model, batch,
                                 lambda: trainer.step(batch))
            step_s, loss = check["seconds"], check["loss"]
        else:
            t0 = time.perf_counter()
            loss = float(trainer.step(batch)["loss"])
            step_s = time.perf_counter() - t0
        steps.append({"nodes": nn, "edges": ne, "sample_merge_s": sample_s, "step_s": step_s,
                      "loss": loss})
    torch.cuda.synchronize()
    launches = dict(build.launches)
    emit("gnn_sampled", arch="gin-tu", shape="minibatch_lg", config={
             "n_layers": gcfg.n_layers, "d_hidden": gcfg.d_hidden, "d_in": gcfg.d_in,
             "n_classes": gcfg.n_classes}, scale=config.scale, n=cfg.n,
         m=stream.num_edges, n_pad=n_pad, e_pad=e_pad, coarsening=trainer.coarsening,
         seconds={"setup": setup_s, "csr_sampler": trainer.csr_seconds}, steps=steps,
         step1_vs_cpu=check, launches=launches)
    if not _one_edges_call(launches):
        raise AssertionError(f"the sampled trainer launched {launches}, not one per-edge call")
    if not all(np.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"gnn_sampled: a loss is not finite: {steps}")
    return sum(launches.values())


def phase_gnn_full():
    """GIN at gin-tu's width on the ogb_products dimensions (2,449,152 nodes,
    61,859,328 edges after padding, 100 features, 47 classes, no edge
    chunks), a ``make_gnn_batch(seed=0)`` batch on the card: GNN_FULL_STEPS
    AdamW steps, each timed with CUDA events, and the peak device memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_gnn_batch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import (
        gnn_batch_dims,
        gnn_shape_config,
        make_gnn_model,
        make_gnn_train_step,
    )
    from repro_torch.optim import AdamW, AdamWConfig

    arch = get_arch("gin-tu")
    shape = arch.shapes["ogb_products"]
    gcfg = gnn_shape_config(arch, shape)
    N, E = gnn_batch_dims(shape, gcfg.edge_chunk)
    t0 = time.perf_counter()
    batch = make_gnn_batch(N, E, gcfg.d_in, n_classes=shape.n_classes, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    opt_cfg = AdamWConfig()
    model = make_gnn_model(arch, shape)
    opt = AdamW(model.parameters(), opt_cfg)
    step = make_gnn_train_step(arch, shape, opt_cfg)
    build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(GNN_FULL_STEPS):
        t, out = cuda_ms(lambda: step(model, opt, batch))
        ms.append(t)
        losses.append(float(out["loss"]))
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.launches)
    emit("gnn_full", arch="gin-tu", shape="ogb_products", n=N, e=E, valid_edges=int(
             batch.edge_mask.sum()), d_in=gcfg.d_in, n_classes=gcfg.n_classes,
         edge_chunk=gcfg.edge_chunk, seconds={"make_gnn_batch": gen_s}, step_ms=ms,
         ms_per_step=float(np.median(ms[1:])), losses=losses, peak_bytes=peak,
         launches=launches)
    if not all(np.isfinite(losses)) or launches:
        raise AssertionError(f"gnn_full: losses {losses}, launches {launches}")


def phase_gnn_molecule():
    """EGNN (4 x 64), MeshGraphNet (15 x 128) and Equiformer-v2 (12 x 128,
    l_max 6, 8 heads) at their published widths on the molecule shape (128
    graphs of 30 nodes and 64 edges, 16 features): one AdamW step each on
    the card, its loss and gradients held to the CPU, and its peak memory.
    Equiformer-v2 is held to the CPU at EQV2_HELD_LAYERS layers (its 12 take
    ~110 s there); its 12-layer step runs on the card after it, timed, its
    loss finite."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_gnn_batch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import (
        _gnn_module,
        gnn_batch_dims,
        gnn_shape_config,
        make_gnn_model,
        make_gnn_train_step,
    )
    from repro_torch.optim import AdamW, AdamWConfig

    out = {}
    build.launches.clear()
    for arch_id in ("egnn", "meshgraphnet", "equiformer-v2"):
        arch = get_arch(arch_id)
        shape = arch.shapes["molecule"]
        gcfg = gnn_shape_config(arch, shape)
        N, E = gnn_batch_dims(shape, gcfg.edge_chunk)
        batch = make_gnn_batch(N, E, gcfg.d_in, d_out=gcfg.d_out, coords=True,
                               n_graphs=shape.batch_graphs, seed=0)
        model = make_gnn_model(arch, shape)
        opt_cfg = AdamWConfig()
        step = make_gnn_train_step(arch, shape, opt_cfg)
        held = model
        if arch_id == "equiformer-v2":
            held = _gnn_module(arch).MODEL(dataclasses.replace(gcfg, n_layers=EQV2_HELD_LAYERS))
        opt = AdamW(held.parameters(), opt_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        check = _held_to_cpu(arch_id, held, batch, lambda: step(held, opt, batch))
        row = {"n": N, "e": E, "n_layers": gcfg.n_layers, "d_hidden": gcfg.d_hidden, **check,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        if held is not model:
            del held, opt
            opt = AdamW(model.parameters(), opt_cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = float(step(model, opt, batch)["loss"])
            row["held_n_layers"] = EQV2_HELD_LAYERS
            row["full_depth"] = {"seconds": time.perf_counter() - t0, "loss": loss,
                                 "peak_bytes": torch.cuda.max_memory_allocated()}
            if not np.isfinite(loss):
                raise AssertionError(f"{arch_id}: the {gcfg.n_layers}-layer loss is {loss}")
        out[arch_id] = row
    launches = dict(build.launches)
    emit("gnn_molecule", shape="molecule", models=out, launches=launches)
    if launches:
        raise AssertionError(f"gnn_molecule launched {launches}")


def _lm_bytes_and_ops(cfg, B, S, cache_len):
    """(bytes a decode step must move, operations a prefill must do): the
    weights once (less the embedding rows not read) and the filled cache
    slots, k and v, once; 2 x tokens x the weights multiplied, plus the
    causal half of the attention products (QK and PV)."""
    import math

    from repro_torch.models.param import iter_specs
    from repro_torch.models.transformer import param_specs

    specs = dict(iter_specs(param_specs(cfg)))
    nbytes = {k: math.prod(v.shape) * v.dtype.itemsize for k, v in specs.items()}
    item = specs["embed"].dtype.itemsize
    weights = sum(nbytes.values()) - nbytes["embed"] + B * cfg.d_model * item
    cache = 2 * cfg.n_layers * B * cache_len * cfg.n_kv * cfg.d_head * item
    matmul = sum(math.prod(specs[f"layers.{k}"].shape) for k in ("wq", "wk", "wv", "wo", "w1", "w2"))
    ops = 2 * B * S * matmul + 2 * B * cfg.d_model * cfg.vocab_padded
    ops += 2 * 2 * B * cfg.n_layers * cfg.n_heads * cfg.d_head * S * (S + 1) // 2
    return weights + cache, ops


def phase_lm_serve():
    """gemma-7b at its published config (28 layers, d 3072, vocab 256,000,
    bf16 weights; its stream float32, as the reference's), weights drawn on
    the card from a seeded CUDA generator; LM_BATCH requests of 32,768
    tokens from ``TokenPipeline(seed=0)``: ``make_lm_prefill`` at
    prefill_32k's overrides into a cache of LM_MAX_LEN slots, then
    LM_DECODE_STEPS greedy ``decode_step``s, each committing its k/v in
    place at ``32768 + t``. Then, the cache freed, the reference's own
    contract (``test_arch_smoke.py``): decode step 1's logits of request 0
    against ``backbone`` on its 32,769 tokens (a ragged last attention
    chunk) through ``lm_head``, within LM_DECODE_RTOL of the largest logit;
    and the standard deviation of layer 0's attention scores on the first
    1,024 tokens (the attention projections' fan-in, ROADMAP.md §3)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.steps import lm_shape_config, make_lm_prefill
    from repro_torch.models import transformer as tfm

    assert not torch.backends.cuda.matmul.allow_tf32
    arch = get_arch("gemma-7b")
    cfg = arch.config
    pshape, dshape = arch.shapes["prefill_32k"], arch.shapes["decode_32k"]
    S = pshape.seq_len
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = tfm.Transformer(cfg, generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tokens = TokenPipeline(vocab=cfg.vocab, batch=LM_BATCH, seq_len=S, seed=0).batch_at(0)
    prefill = make_lm_prefill(arch, pshape, max_len=LM_MAX_LEN)
    pcfg, dcfg = lm_shape_config(arch, pshape), lm_shape_config(arch, dshape)
    torch.cuda.synchronize()
    build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, (cache, logits) = cuda_ms(lambda: prefill(model, {"tokens": tokens}))
    finite = bool(torch.isfinite(logits).all())
    token = logits.argmax(-1)
    first_token = token.clone()

    def decode(pos):
        lg, (k, v) = tfm.decode_step(model, cache, token, pos, dcfg)
        cache["k"][:, :, pos] = k[:, :, 0]
        cache["v"][:, :, pos] = v[:, :, 0]
        return lg

    step_ms, first = [], None
    for t in range(LM_DECODE_STEPS):
        ms, lg = cuda_ms(lambda: decode(S + t))
        step_ms.append(ms)
        finite &= bool(torch.isfinite(lg).all())
        if t == 0:
            first = lg[0].float().cpu()
        token = lg.argmax(-1)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.launches)
    del cache
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.inference_mode():
        seq = torch.cat([tokens[0], first_token[:1].to(tokens.dtype)])[None]  # 32,769 tokens
        ref = tfm.lm_logits(model, tfm.backbone(model, seq, pcfg)[:, -1], dcfg).float().cpu()[0]
        lp = model.layer_params(0)
        n = min(1024, S)
        h = tfm.rmsnorm(tfm._embed(model, tokens[:1, :n]), lp["ln1"], cfg.norm_eps)
        q, k, _ = tfm._qkv(h, lp, cfg, torch.arange(n, device=h.device)[None], model.rope_freqs)
        score_std = float(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).std()
                          / np.sqrt(cfg.d_head))
    check_s = time.perf_counter() - t0
    scale = float(ref.abs().max())
    err = float((first - ref).abs().max()) / scale
    decode_ms = float(np.median(step_ms[1:]))
    step_bytes, prefill_ops = _lm_bytes_and_ops(cfg, LM_BATCH, S, S + LM_DECODE_STEPS // 2)
    emit("lm_serve", arch="gemma-7b", params=cfg.param_count(), n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, batch=LM_BATCH, prompt=S, max_len=LM_MAX_LEN,
         attn_chunk=pcfg.attn_chunk, decode_steps=LM_DECODE_STEPS,
         reduced={"prefill_32k.global_batch": "32 -> 2", "decode_32k.global_batch": "128 -> 2",
                  "why": "one card holds 80 GB: 18.65 GB of weights and 15.0 GB of KV cache "
                         "a 32,768-token request"},
         seconds={"build_on_card": build_s, "check": check_s},
         prefill_ms=prefill_ms, prefill_tokens_per_s=LM_BATCH * S / (prefill_ms / 1e3),
         prefill_ops=prefill_ops, prefill_bound_ms_f32=prefill_ops / F32_OPS_PER_S * 1e3,
         prefill_bound_ms_bf16=prefill_ops / BF16_OPS_PER_S * 1e3,
         decode_step_ms=step_ms, decode_ms=decode_ms,
         decode_tokens_per_s=LM_BATCH / (decode_ms / 1e3), decode_step_bytes=step_bytes,
         decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3, peak_bytes=peak,
         resident_before_bytes=resident, finite=finite,
         decode_vs_backbone_err_over_max=err, max_abs_logit=scale,
         layer0_score_std=score_std, launches=launches)
    if launches or not finite or err > LM_DECODE_RTOL:
        raise AssertionError(f"lm_serve: launches {launches}, finite {finite}, "
                             f"decode vs backbone {err} (limit {LM_DECODE_RTOL})")
    del model
    torch.cuda.empty_cache()


def _tie_router(model):
    """Make each layer's router column 1 equal to column 0: every token's
    probabilities then tie between experts 0 and 1 (the routing tie-break)."""
    import torch

    with torch.no_grad():
        model.layers.router[..., 1] = model.layers.router[..., 0]


def phase_lm_held_to_cpu():
    """gemma-7b, internlm2-20b, minicpm-2b and moonshot-v1-16b-a3b (two
    router columns tied) at their published widths cut to LM_HELD_LAYERS
    layers, float32, drawn on the card from a seeded CUDA generator and
    copied to the CPU: ``prefill`` of 2 x LM_HELD_PROMPT tokens and
    LM_HELD_STEPS decode steps (the pipeline's next tokens) on both; each
    logit's error over the largest magnitude, TF32 off."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm

    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    build.launches.clear()
    for arch_id in LM_HELD_ARCHS:
        cfg = dataclasses.replace(get_arch(arch_id).config, n_layers=LM_HELD_LAYERS,
                                  param_dtype=torch.float32)
        card = tfm.Transformer(cfg, generator=torch.Generator("cuda").manual_seed(0))
        if cfg.is_moe:
            _tie_router(card)
        t0 = time.perf_counter()
        host = copy.deepcopy(card).to("cpu")
        build_s = time.perf_counter() - t0
        tokens = TokenPipeline(vocab=cfg.vocab, batch=2, seq_len=LM_HELD_PROMPT + LM_HELD_STEPS,
                               seed=0, device="cpu").batch_at(0)
        runs, secs = {}, {}
        for name, model in (("cpu", host), ("cuda", card)):
            dev = model.embed.device
            t0 = time.perf_counter()
            cache, last = tfm.prefill(model, tokens[:, :LM_HELD_PROMPT].to(dev),
                                      max_len=LM_HELD_PROMPT + LM_HELD_STEPS)
            logits = [tfm.lm_logits(model, last).detach()]
            for t in range(LM_HELD_STEPS):
                pos = LM_HELD_PROMPT + t
                lg, (k, v) = tfm.decode_step(model, cache, tokens[:, pos].to(dev), pos)
                cache["k"][:, :, pos] = k[:, :, 0]
                cache["v"][:, :, pos] = v[:, :, 0]
                logits.append(lg)
            runs[name] = torch.stack(logits).float().cpu()
            secs[name] = time.perf_counter() - t0
        want = runs["cpu"]
        err = float((runs["cuda"] - want).abs().max() / want.abs().max())
        out[arch_id] = {"params": cfg.param_count(), "d_model": cfg.d_model,
                        "err_over_max": err, "finite": bool(torch.isfinite(runs["cuda"]).all()),
                        "router_tied": cfg.is_moe, "copy_to_cpu_s": build_s,
                        "cpu_s": secs["cpu"], "card_s": secs["cuda"]}
        del host, card, cache
        torch.cuda.empty_cache()
    launches = dict(build.launches)
    emit("lm_held_to_cpu", n_layers=LM_HELD_LAYERS, prompt=LM_HELD_PROMPT,
         decode_steps=LM_HELD_STEPS, dtype="float32", models=out, launches=launches)
    bad = {k: v for k, v in out.items() if not (v["finite"] and v["err_over_max"] <= LM_HELD_RTOL)}
    if bad or launches:
        raise AssertionError(f"lm_held_to_cpu: {bad}, launches {launches}")


def _torch_topk_two_stage(scores, k: int, shards: int = 16):
    """``sharded_topk`` with ``torch.topk`` in both stages, so among equal
    scores any index (the route without the tie-break; timed beside it)."""
    import torch

    B, V = scores.shape
    v1, i1 = torch.topk(scores.reshape(B, shards, V // shards), k, dim=-1)
    base = (torch.arange(shards, device=scores.device) * (V // shards))[None, :, None]
    gidx = (i1 + base).reshape(B, shards * k)
    v2, i2 = torch.topk(v1.reshape(B, shards * k), k, dim=-1)
    return v2, torch.gather(gidx, 1, i2)


def _serve_bulk_in_turns(step, model, batch):
    """serve_bulk with ``torch.topk``'s two stages, then the port's tie-exact
    ``sharded_topk`` twice, then ``torch.topk``'s again (CUDA events): the
    tie-break's cost; the values of the two routes are equal."""
    import numpy as np

    from repro_torch.launch import steps as steps_mod

    exact = steps_mod.sharded_topk
    secs = {"torch_topk": [], "lower_index": []}
    outs = {}
    try:
        for route in ("torch_topk", "lower_index", "lower_index", "torch_topk"):
            steps_mod.sharded_topk = _torch_topk_two_stage if route == "torch_topk" else exact
            t, outs[route] = cuda_ms(lambda: step(model, batch))
            secs[route].append(t / 1e3)
    finally:
        steps_mod.sharded_topk = exact
    same_values = bool((outs["torch_topk"][0] == outs["lower_index"][0]).all())
    if not same_values:
        raise AssertionError("serve_bulk: the two top-k routes returned other values")
    return {"seconds": secs, "median_s": {k: float(np.median(v)) for k, v in secs.items()},
            "same_values": same_values,
            "same_index_share": float((outs["torch_topk"][1] == outs["lower_index"][1])
                                      .float().mean())}


def phase_recsys_serve():
    """BERT4Rec at its published config (1,048,576 items x 64, 2 blocks, 2
    heads, seq 200, float32), built from seed 0, on its three serving
    shapes through ``make_recsys_step``: serve_p99 (batches of 512 users,
    RECSYS_P99_BATCHES timed after one warm-up), serve_bulk (262,144 users
    in 64 chunks of 4,096, each a 17.2 GB block of scores, top 100) and
    retrieval_cand (1 user x 1,000,000 candidates drawn with replacement,
    top 100), serve_bulk again with ``torch.topk``'s two stages in turns with
    the tie-exact ``sharded_topk`` (``_serve_bulk_in_turns``); then one
    serve_p99 batch's scores and top 100 on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import RecsysPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_recsys_step, sharded_topk
    from repro_torch.models import bert4rec as b4r

    arch = get_arch("bert4rec")
    cfg = arch.config
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = b4r.Bert4Rec(cfg, device="cpu", seed=0)
    model = b4r.Bert4Rec(cfg, seed=0)  # the same draws, copied to the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def pipe(shape, seed):
        return RecsysPipeline(cfg.item_vocab, shape.batch, cfg.seq_len, cfg.n_mask,
                              cfg.n_negatives, cfg.n_context, seed=seed)

    out = {}
    build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    shape = arch.shapes["serve_p99"]
    step = make_recsys_step(arch, shape)
    p99 = pipe(shape, 0)
    step(model, p99.batch_at(RECSYS_P99_BATCHES))  # warm-up
    ms = []
    for i in range(RECSYS_P99_BATCHES):
        batch = p99.batch_at(i)
        torch.cuda.synchronize()
        t, (vals, idxs) = cuda_ms(lambda: step(model, batch))
        ms.append(t)
    out["serve_p99"] = {"batch": shape.batch, "batch_ms": ms, "median_ms": float(np.median(ms)),
                        "p99_ms": float(np.percentile(ms, 99)),
                        "finite": bool(torch.isfinite(vals).all())}
    shape = arch.shapes["serve_bulk"]
    t0 = time.perf_counter()
    batch = pipe(shape, 1).batch_at(0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t, (vals, idxs) = cuda_ms(lambda: make_recsys_step(arch, shape)(model, batch))
    out["serve_bulk"] = {"users": shape.batch, "chunks": shape.batch // 4096, "seconds": t / 1e3,
                         "users_per_s": shape.batch / (t / 1e3), "batch_gen_s": gen_s,
                         "out_shape": list(vals.shape), "finite": bool(torch.isfinite(vals).all())}
    del vals, idxs
    out["serve_bulk_top_k"] = _serve_bulk_in_turns(make_recsys_step(arch, shape), model, batch)
    del batch
    shape = arch.shapes["retrieval_cand"]
    batch = pipe(shape, 2).batch_at(0)
    batch["candidates"] = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.item_vocab, shape.n_candidates).astype(np.int32)).cuda()
    rstep = make_recsys_step(arch, shape)
    rstep(model, batch)
    t, (vals, idxs) = cuda_ms(lambda: rstep(model, batch))
    out["retrieval_cand"] = {"candidates": shape.n_candidates, "ms": t,
                             "finite": bool(torch.isfinite(vals).all())}
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.launches)
    batch = p99.batch_at(0)
    with torch.inference_mode():
        scores = b4r.serve_scores(model, batch["item_ids"], batch["context_ids"])
        vals, idxs = sharded_topk(scores, 100)
        t0 = time.perf_counter()
        hb = {k: v.cpu() for k, v in batch.items()}
        want = b4r.serve_scores(host, hb["item_ids"], hb["context_ids"])
        wvals, widxs = sharded_topk(want, 100)
        cpu_s = time.perf_counter() - t0
    scale = float(want.abs().max())
    check = {"scores_err_over_max": float((scores.cpu() - want).abs().max()) / scale,
             "top100_err_over_max": float((vals.cpu() - wvals).abs().max()) / scale,
             "top100_same_index_share": float((idxs.cpu() == widxs).float().mean()),
             "cpu_seconds": cpu_s}
    emit("recsys_serve", arch="bert4rec", items=cfg.item_vocab, embed_dim=cfg.embed_dim,
         seq_len=cfg.seq_len, seconds={"build": build_s}, shapes=out, peak_bytes=peak,
         serve_p99_vs_cpu=check, launches=launches)
    finite = all(v["finite"] for v in out.values() if "finite" in v)
    if (launches or not finite or check["scores_err_over_max"] > RECSYS_RTOL
            or check["top100_err_over_max"] > RECSYS_RTOL):
        raise AssertionError(f"recsys_serve: launches {launches}, finite {finite}, {check}")


def _train_step_held(label, card, make_step, batch, lr):
    """One train step of ``card`` (a model on the card) and of a CPU copy of
    it, each with its own AdamW at ``lr``: the loss within GNN_LOSS_RTOL,
    each gradient within GNN_GRAD_RTOL of max(its largest magnitude, 1e-3)
    (``grad_errors``), and each parameter after the step within 2 * lr of
    the CPU's (the first update is about lr * sign(g), so a gradient that
    is rounding noise may take the other sign; ``moved_share`` counts the
    entries further apart than 1e-6). Frees the CPU copy."""
    import copy

    import torch

    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.testing.gnn_check import grad_errors

    t0 = time.perf_counter()
    host = copy.deepcopy(card).to("cpu")
    copy_s = time.perf_counter() - t0
    runs = {}
    for name, model in (("cpu", host), ("cuda", card)):
        dev = next(model.parameters()).device
        opt = AdamW(model.parameters(), AdamWConfig(lr=lr))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = make_step(dev)(model, opt, batch)
        loss = float(out["loss"])
        runs[name] = {"loss": loss, "grad_norm": float(out["grad_norm"]),
                      "seconds": time.perf_counter() - t0}
        del opt
    errs = grad_errors(card, {n: p.grad for n, p in host.named_parameters()})
    worst = max(errs, key=errs.get)
    param_err, moved, total = 0.0, 0, 0
    for (name, a), (_, b) in zip(card.named_parameters(), host.named_parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        param_err = max(param_err, float(diff.max()))
        moved += int((diff > 1e-6).sum())
        total += diff.numel()
    del host
    want = runs["cpu"]["loss"]
    check = {"loss": runs["cuda"]["loss"], "loss_cpu": want,
             "loss_rel_err": abs(runs["cuda"]["loss"] - want) / abs(want),
             "grad_norm": runs["cuda"]["grad_norm"], "grad_norm_cpu": runs["cpu"]["grad_norm"],
             "grad_err_over_max": errs[worst], "worst_grad": worst,
             "param_max_abs_err": param_err, "param_bound": 2 * lr,
             "moved_share": moved / max(total, 1), "lr": lr, "card_s": runs["cuda"]["seconds"],
             "cpu_s": runs["cpu"]["seconds"], "copy_to_cpu_s": copy_s}
    if not (check["loss_rel_err"] <= GNN_LOSS_RTOL and errs[worst] <= GNN_GRAD_RTOL
            and param_err <= 2 * lr * (1 + 1e-3) + 1e-6):
        raise AssertionError(f"{label}: the train step on the card differs from the CPU: {check}")
    return check


def _state_bytes(model, opt) -> dict:
    """Bytes of the weights, their gradients and the AdamW moments."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = sum(t.numel() * t.element_size() for st in opt.state.values()
                  for k, t in st.items() if k in ("m", "v"))
    return {"weights": weights, "gradients": weights, "moments": moments,
            "total": 2 * weights + moments}


def _lm_train_ops(cfg, B, S):
    """Model operations of one train step: 6 x the multiplied weights (the
    layers' projections and the head) x tokens, plus the causal half of the
    attention products (QK and PV) forward and backward (x 3)."""
    import math

    from repro_torch.models.param import iter_specs
    from repro_torch.models.transformer import param_specs

    specs = dict(iter_specs(param_specs(cfg)))
    matmul = sum(math.prod(specs[f"layers.{k}"].shape) for k in ("wq", "wk", "wv", "wo", "w1", "w2"))
    matmul += math.prod(specs["lm_head"].shape)
    attn = 3 * 2 * 2 * B * cfg.n_layers * cfg.n_heads * cfg.d_head * S * (S + 1) // 2
    return 6 * matmul * B * S + attn, matmul


def phase_lm_train():
    """minicpm-2b at its published config (40 layers, d 2,304, 36 heads of 64,
    SwiGLU 5,760, vocab 122,753; bf16 weights drawn on the card from a
    seeded CUDA generator; ``default_opt_cfg``: float32 moments) on
    train_4k's 4,096-token sequences, LM_TRAIN_BATCH a step from
    ``TokenPipeline(seed=0)``: LM_TRAIN_STEPS ``make_lm_train_step`` steps
    at the WSD schedule's rates (warm-up, stable and decay one step each),
    each timed with CUDA events; ms a step (median of steps 2 on), tokens/s,
    peak memory, the state's bytes, loss and gradient norm of every step
    (finite) and the model-FLOP share (``mfu_bf16``: ``_lm_train_ops`` over
    the bf16 dense peak)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.steps import default_opt_cfg, lm_shape_config, make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamW, wsd_schedule

    assert not torch.backends.cuda.matmul.allow_tf32
    arch = get_arch(LM_TRAIN_ARCH)
    cfg, shape = arch.config, arch.shapes["train_4k"]
    B, S = LM_TRAIN_BATCH, shape.seq_len
    opt_cfg = default_opt_cfg(arch)
    torch.cuda.empty_cache()
    resident, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    model = tfm.Transformer(cfg, generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(model.parameters(), opt_cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    step = make_lm_train_step(arch, shape, opt_cfg)
    pipe = TokenPipeline(cfg.vocab, B, S, seed=0)
    build.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(LM_TRAIN_STEPS):
        tokens = pipe.batch_at(i)
        lr = float(wsd_schedule(i, opt_cfg.lr, warmup=1, stable=1, decay=1))
        ms, out = cuda_ms(lambda: step(model, opt, {"tokens": tokens}, lr=lr))
        steps.append({"ms": ms, "lr": lr, "loss": float(out["loss"]),
                      "grad_norm": float(out["grad_norm"])})
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.launches)
    state = _state_bytes(model, opt)
    ms = float(np.median([s["ms"] for s in steps[1:]]))
    ops, matmul_params = _lm_train_ops(cfg, B, S)
    tcfg = lm_shape_config(arch, shape)
    finite = all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps)
    emit("lm_train", arch=LM_TRAIN_ARCH, shape="train_4k", params=cfg.param_count(),
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads, vocab=cfg.vocab,
         batch=B, seq_len=S, attn_chunk=tcfg.attn_chunk, attn_par=tcfg.attn_par,
         loss_chunk=tcfg.loss_chunk, remat=tcfg.remat, moment_dtype=str(opt_cfg.moment_dtype),
         reduced={"train_4k.global_batch": f"256 -> {B}",
                  "why": f"one card holds 80 GB: the state is {state['total'] / 1e9:.2f} GB and "
                         f"a sequence's [{cfg.n_heads}, {S}, {S}] float32 score block is "
                         f"{cfg.n_heads * S * S * 4 / 1e9:.2f} GB, held with its probabilities "
                         "through its backward"},
         seconds={"build_on_card": build_s}, steps=steps, step_ms=ms,
         tokens_per_s=B * S / (ms / 1e3), model_ops=ops, matmul_params=matmul_params,
         mfu_bf16=ops / (ms / 1e3) / BF16_OPS_PER_S, peak_bytes=peak,
         resident_before_bytes=resident, reserved_before_bytes=reserved, state_bytes=state,
         finite=finite, launches=launches)
    del model, opt, step
    torch.cuda.empty_cache()
    if launches or not finite:
        raise AssertionError(f"lm_train: launches {launches}, finite {finite}: {steps}")


def phase_lm_train_held_to_cpu():
    """minicpm-2b and moonshot-v1-16b-a3b (two router columns tied: the
    routing tie-break is held too) at their published widths cut to
    LM_TRAIN_HELD_LAYERS layers, float32, drawn on the card from a seeded CUDA generator: one
    ``make_lm_train_step`` step on 2 x LM_TRAIN_HELD_TOKENS tokens on the
    card and on a CPU copy (``_train_step_held``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    build.launches.clear()
    for arch_id, n_layers in LM_TRAIN_HELD_LAYERS.items():
        arch = get_arch(arch_id)
        cfg = dataclasses.replace(arch.config, n_layers=n_layers, param_dtype=torch.float32)
        arch = dataclasses.replace(arch, config=cfg)
        shape = ShapeSpec("held", "train", seq_len=LM_TRAIN_HELD_TOKENS, global_batch=2)
        card = tfm.Transformer(cfg, generator=torch.Generator("cuda").manual_seed(0))
        if cfg.is_moe:
            _tie_router(card)
        tokens = TokenPipeline(cfg.vocab, 2, LM_TRAIN_HELD_TOKENS, seed=0, device="cpu").batch_at(0)
        lr = AdamWConfig().lr
        out[arch_id] = {"params": cfg.param_count(), "d_model": cfg.d_model,
                        "router_tied": cfg.is_moe, **_train_step_held(
                            f"lm_train_held_to_cpu {arch_id}", card,
                            lambda dev: make_lm_train_step(arch, shape, AdamWConfig(lr=lr), device=dev),
                            {"tokens": tokens}, lr)}
        del card
        torch.cuda.empty_cache()
    launches = dict(build.launches)
    emit("lm_train_held_to_cpu", n_layers=LM_TRAIN_HELD_LAYERS, tokens=[2, LM_TRAIN_HELD_TOKENS],
         dtype="float32",
         models=out, launches=launches)
    if launches:
        raise AssertionError(f"lm_train_held_to_cpu launched {launches}")


def phase_recsys_train():
    """BERT4Rec at its published config (1,048,576 items x 64, 2 blocks, 2
    heads, seq 200, n_mask 40, 8,192 shared negatives, float32), drawn on
    the card from a seeded CUDA generator: one ``make_recsys_step`` train
    step of RECSYS_HELD_USERS users on a copy on the card and on the CPU
    (``_train_step_held``), then RECSYS_TRAIN_STEPS steps of
    RECSYS_TRAIN_BATCH users from ``RecsysPipeline(seed=0)``, each timed
    with CUDA events: ms a step (median of steps 2 on), users/s, peak
    memory and the state's bytes."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import RecsysPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.steps import default_opt_cfg, make_recsys_step
    from repro_torch.models import bert4rec as b4r
    from repro_torch.optim import AdamW

    arch = get_arch("bert4rec")
    cfg = arch.config
    opt_cfg = default_opt_cfg(arch)
    shape = dataclasses.replace(arch.shapes["train_batch"], batch=RECSYS_TRAIN_BATCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = b4r.Bert4Rec(cfg, generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def pipe(users, seed, device=None):
        return RecsysPipeline(cfg.item_vocab, users, cfg.seq_len, cfg.n_mask, cfg.n_negatives,
                              cfg.n_context, seed=seed, device=device)

    build.launches.clear()
    held_shape = dataclasses.replace(shape, batch=RECSYS_HELD_USERS)
    check = _train_step_held(
        "recsys_train", copy.deepcopy(model),
        lambda dev: make_recsys_step(arch, held_shape, opt_cfg, device=dev),
        pipe(RECSYS_HELD_USERS, 1, "cpu").batch_at(0), opt_cfg.lr)
    torch.cuda.empty_cache()
    opt = AdamW(model.parameters(), opt_cfg)
    step = make_recsys_step(arch, shape, opt_cfg)
    t0 = time.perf_counter()
    batches = [pipe(RECSYS_TRAIN_BATCH, 0).batch_at(i) for i in range(RECSYS_TRAIN_STEPS)]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for b in batches:
        ms, out = cuda_ms(lambda: step(model, opt, b))
        steps.append({"ms": ms, "loss": float(out["loss"]), "grad_norm": float(out["grad_norm"])})
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.launches)
    ms = float(np.median([s["ms"] for s in steps[1:]]))
    B = RECSYS_TRAIN_BATCH
    logits_bytes = B * cfg.n_mask * (1 + cfg.n_negatives) * 4
    finite = all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps)
    emit("recsys_train", arch="bert4rec", items=cfg.item_vocab, embed_dim=cfg.embed_dim,
         seq_len=cfg.seq_len, n_mask=cfg.n_mask, n_negatives=cfg.n_negatives, users=B,
         reduced={"train_batch.batch": f"65536 -> {B}",
                  "why": f"the [B, {cfg.n_mask}, {1 + cfg.n_negatives}] float32 logits are "
                         f"{logits_bytes / 1e9:.1f} GB at {B} users, "
                         f"{65536 * cfg.n_mask * (1 + cfg.n_negatives) * 4 / 1e9:.0f} GB at "
                         "65,536, and the loss holds several such blocks"},
         seconds={"build_on_card": build_s, "batch_gen": gen_s}, steps=steps, step_ms=ms,
         users_per_s=B / (ms / 1e3), peak_bytes=peak, logits_block_bytes=logits_bytes,
         state_bytes=_state_bytes(model, opt), held_to_cpu=check, finite=finite,
         launches=launches)
    del model, opt, batches
    torch.cuda.empty_cache()
    if launches or not finite:
        raise AssertionError(f"recsys_train: launches {launches}, finite {finite}: {steps}")


def _sharded_lm_run(arch, shape, tokens, mesh):
    """SHARDED_STEPS ``make_lm_train_step`` steps (AdamW at SHARDED_LR) of the
    arch's model drawn on the card from seed 0, on ``tokens`` each step,
    under SHARDED_RULES: with ``mesh``, every parameter a DTensor on it and
    the mesh current; with None, the plain model (rules without a mesh
    place nothing). Each step timed with CUDA events; frees the model."""
    import torch

    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import distribute_params
    from repro_torch.optim import AdamW, AdamWConfig

    torch.cuda.empty_cache()
    cfg = arch.config
    model = tfm.Transformer(cfg, generator=torch.Generator("cuda").manual_seed(0))
    placed = None
    if mesh is not None:
        distribute_params(model, tfm.param_specs(cfg), SHARDED_RULES, mesh)
        placed = {n: str(tuple(p.placements)) for n, p in model.named_parameters()}
    opt_cfg = AdamWConfig(lr=SHARDED_LR)
    opt = AdamW(model.parameters(), opt_cfg)
    step = make_lm_train_step(arch, shape, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with sharding_rules(SHARDED_RULES), use_mesh(mesh):
        for _ in range(SHARDED_STEPS):
            ms, out = cuda_ms(lambda: step(model, opt, {"tokens": tokens}))
            steps.append({"ms": ms, "loss": float(out["loss"]),
                          "grad_norm": float(out["grad_norm"])})
    peak = torch.cuda.max_memory_allocated()
    del model, opt
    torch.cuda.empty_cache()
    return {"steps": steps, "peak_bytes": peak, "placements": placed}


def phase_sharded_lm_train():
    """gemma-7b at its published width (d 3,072, 16 heads of 256, GeGLU
    24,576, vocab 256,000) cut to SHARDED_LAYERS layers, float32 weights
    drawn on the card from seed 0: SHARDED_STEPS ``make_lm_train_step``
    steps (a train shape of SHARDED_BATCH x SHARDED_TOKENS tokens, the same
    batch each step, as the JAX package's multi-device test) on a 1x1 NCCL
    mesh (world size 1, a file store under ``build/``) with every parameter
    a DTensor and SHARDED_RULES installed, then the same steps from the
    same weights without a mesh. The losses
    agree within SHARDED_LOSS_RTOL and fall; ms a step and peak memory of
    each. A world larger than 1 needs a card per rank (NCCL refuses two
    ranks on one device): the multi-rank checks are the CPU tests."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import lm_shape_config

    assert not torch.backends.cuda.matmul.allow_tf32
    arch, shape = _sharded_arch_and_shape()
    cfg = arch.config
    tcfg = lm_shape_config(arch, shape)
    tokens = TokenPipeline(cfg.vocab, SHARDED_BATCH, SHARDED_TOKENS, seed=0).batch_at(0)
    store = ROOT / "build" / "sharded_lm.store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    build.launches.clear()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        sharded = _sharded_lm_run(arch, shape, tokens, make_host_mesh(1, 1))
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    plain = _sharded_lm_run(arch, shape, tokens, None)
    launches = dict(build.launches)
    got = np.array([s["loss"] for s in sharded["steps"]])
    want = np.array([s["loss"] for s in plain["steps"]])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    ms = {k: float(np.median([s["ms"] for s in r["steps"][1:]]))
          for k, r in (("sharded", sharded), ("plain", plain))}
    tokens_n = SHARDED_BATCH * SHARDED_TOKENS
    ok = (rel <= SHARDED_LOSS_RTOL and got[-1] < got[0] and want[-1] < want[0]
          and bool(np.isfinite(got).all()) and not launches)
    emit("sharded_lm_train", arch=SHARDED_ARCH, params=cfg.param_count(),
         n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab, dtype="float32",
         mesh={"data": 1, "model": 1}, backend="nccl", rules=SHARDED_RULES,
         batch=SHARDED_BATCH, seq_len=SHARDED_TOKENS, lr=SHARDED_LR,
         attn_chunk=tcfg.attn_chunk, loss_chunk=tcfg.loss_chunk, remat=tcfg.remat,
         reduced={"n_layers": f"28 -> {SHARDED_LAYERS}",
                  "why": f"28 layers of float32 weights, gradients and AdamW moments are "
                         f"{16 * dataclasses.replace(cfg, n_layers=28).param_count() / 1e9:.0f}"
                         " GB; one card holds 80"},
         placements=sharded["placements"], steps={"sharded": sharded["steps"],
                                                  "plain": plain["steps"]},
         step_ms=ms, tokens_per_s={k: tokens_n / (v / 1e3) for k, v in ms.items()},
         peak_bytes={"sharded": sharded["peak_bytes"], "plain": plain["peak_bytes"]},
         loss_max_rel_err=rel, loss_rtol=SHARDED_LOSS_RTOL, bit_equal=bool((got == want).all()),
         launches=launches)
    if not ok:
        raise AssertionError(f"sharded_lm_train: losses {got} against {want} (rel {rel}), "
                             f"launches {launches}")
    return {"peak_bytes": sharded["peak_bytes"], "step_ms": ms["sharded"]}


def _sharded_arch_and_shape():
    """sharded_lm_train's arch (published width, SHARDED_LAYERS layers,
    float32) and train shape."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec

    arch = get_arch(SHARDED_ARCH)
    cfg = dataclasses.replace(arch.config, n_layers=SHARDED_LAYERS, param_dtype=torch.float32)
    return (dataclasses.replace(arch, config=cfg),
            ShapeSpec("sharded", "train", seq_len=SHARDED_TOKENS, global_batch=SHARDED_BATCH))


def _dryrun_child(measured_json: str):
    """The dry-run phase's body, in its own process: the calibration, then
    DRYRUN_CELLS; one JSON line each."""
    import torch

    from repro_torch.launch.dryrun import calibrate, run_cell
    from repro_torch.optim import AdamWConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    arch, shape = _sharded_arch_and_shape()
    t0 = time.perf_counter()
    cal = calibrate(arch, shape, SHARDED_RULES, json.loads(measured_json),
                    AdamWConfig(lr=SHARDED_LR))
    print(json.dumps({"calibration": cal, "seconds": time.perf_counter() - t0,
                      "torch": torch.__version__}), flush=True)
    for arch_id, shape_name, multi_pod in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = run_cell(arch_id, shape_name, multi_pod)
        print(json.dumps({"cell": rec, "seconds": time.perf_counter() - t0}), flush=True)


def phase_dryrun(measured):
    """The dry-run tooling (``repro_torch.launch.dryrun``) in a subprocess
    with its own timeout: its model of sharded_lm_train's step on a 1x1
    world held to what that phase measured (``measured``: peak bytes, ms a
    step) and to ``FlopCounterMode`` over one step on the card, then
    DRYRUN_CELLS on fake worlds of 256 and 512 ranks (``meta`` tensors,
    nothing on the card), each record printed on a line of its own. Fails
    if the calibration misses its bands, a cell records an error or no
    peak, or the child fails or outlives DRYRUN_TIMEOUT_S."""
    t0 = time.perf_counter()
    code = f"import chip_smoke; chip_smoke._dryrun_child({json.dumps(json.dumps(measured))})"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S)
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    cal = next((l for l in lines if "calibration" in l), None)
    cells = [l for l in lines if "cell" in l]
    for c in cells:
        emit("dryrun_cell", seconds=c["seconds"], **c["cell"])
    emit("dryrun", seconds=time.perf_counter() - t0, returncode=proc.returncode,
         torch=cal and cal["torch"], calibration=cal and {
             k: v for k, v in cal["calibration"].items() if k != "record"},
         calibration_record=cal and cal["calibration"]["record"],
         calibration_s=cal and cal["seconds"], cells=len(cells))
    bad = [c["cell"] for c in cells
           if "error" in c["cell"] or not c["cell"]["memory"]["peak_per_device"] > 0]
    if proc.returncode or cal is None or not cal["calibration"]["ok"] or bad \
            or len(cells) != len(DRYRUN_CELLS):
        raise AssertionError(f"dryrun: rc {proc.returncode}, calibration "
                             f"{cal and cal['calibration']['ok']}, bad cells {bad}; "
                             f"stderr {proc.stderr[-3000:]}")


def phase_examples():
    """The two matching examples at their default arguments on the card:
    ``launch/quickstart.py`` (the four Part-1 engines, the exact MWM and its
    ratio, the H100 plan) and ``launch/matching_e2e.py`` (custom CSR,
    ``mwm_blocked(backend="kernel")``, the host merge, the straggler monitor,
    a checkpoint under ``build/`` and the restart), each with the launch
    counts set to 0 just before it; the rounds engine (Part 1 at their
    L <= 64) must launch in both and each ratio be at most 4 + eps. Returns
    the rounds engine's launches of each."""
    import shutil

    from repro_torch.kernels import build
    from repro_torch.kernels.substream_match import kernel
    from repro_torch.launch import matching_e2e, quickstart

    runs, launches = {}, {}
    ckpt = ROOT / "build" / "matching_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    for name, fn in (("quickstart", quickstart.run),
                     ("matching_e2e", lambda: matching_e2e.run(ckpt_dir=str(ckpt)))):
        build.launches.clear()
        t0 = time.perf_counter()
        runs[name] = fn()
        runs[name]["wall_s"] = time.perf_counter() - t0
        launches[name] = dict(build.launches)
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("examples", runs=runs, launches=launches)
    rounds = {name: launches[name].get(kernel.ROUNDS_NAME, 0) for name in runs}
    bad = [name for name, r in runs.items()
           if rounds[name] <= 0 or not r["ratio"] <= r["bound"] + 1e-6]
    if bad:
        raise AssertionError(f"examples {bad}: launches {launches}, "
                             f"ratios { {k: (r['ratio'], r['bound']) for k, r in runs.items()} }")
    return rounds


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels.substream_match import kernel

    device, smi = phase_device()
    phase_build()
    # the training phases first, on an empty card: minicpm-2b's step at its
    # batch peaks at ~76 GB, and after the serving phases in the same process
    # it ran out of memory with 19.6 GiB reserved by the allocator and free
    phase_lm_train()
    phase_lm_train_held_to_cpu()
    phase_recsys_train()
    phase_dryrun(phase_sharded_lm_train())
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
    epoch_full = phase_epoch_path(cfg, unpacked)
    phase_epoch_snapshots(cfg, unpacked, epoch_full)
    del unpacked["blocked"], unpacked["one_shot"]
    merge = phase_merge_device(stream, cfg, main)
    phase_main_telemetry(config, stream, cfg, main)
    del main["result"]
    phase_validate(stream, cfg)
    phase_rounds_path(config, stream, cfg, main)
    coarsen_launches = phase_substrate(config, stream, cfg)
    gnn_launches = phase_gnn_sampled(config, stream, cfg)
    phase_gnn_full()
    phase_gnn_molecule()
    del stream
    phase_blocked_wave_route(config.K)
    phase_fallback()
    phase_rounds_sharded(config)
    phase_real_graph(config)
    phase_lm_serve()
    phase_lm_held_to_cpu()
    phase_recsys_serve()
    example_launches = phase_examples()
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
        "launches_coarsen_by_matching": coarsen_launches,
        "launches_gnn_train": gnn_launches,
        "launches_examples": example_launches,
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
