"""Card-only tests of the port, the one home of its checks on the card
(``chip_smoke.py`` builds the libraries and times the kernels; what the
card must do is decided here):

* the CUDA kernels (packed and unpacked layouts) against their plain
  versions, with and without carried bits, the per-edge kernels on streams
  aimed at their batch window, the four wave kernels on streams aimed at
  their slot ring (against the packed per-edge kernel as well), the rounds
  engine against the walker and its numpy model, its slices and grids, and
  40 repeated calls on the blocked streams of two benchmark cells;
* the main path and the epoch executor (with a resume) on the card against
  the same calls on the CPU, the main path's launches, spans and counters,
  and one name for a card (a stream on it is not copied again);
* the robustness and observability layers: the per-edge kernels at L = 1
  (the device merge's shape), ``merge_device``, every rung of the fallback
  ladder, the telemetry records of the three entries, ``validate``, and
  snapshots with the execution guard around the epoch executor;
* the rounds (also at the paper's size), G-SEQ, the graph substrate, the
  sampled GIN trainer's coarsening and step, and the two matching examples;
* one train step of each GNN, the serving paths (the five LMs' prefill and
  decode, decode against ``backbone``, BERT4Rec's serving and retrieval) and
  the training paths (each LM, also minicpm-2b in bfloat16, and BERT4Rec)
  against the CPU at their smoke configs, launching no kernel of the port;
  a card build against a CPU build from one seed, draws from a CUDA
  generator, the top-k and MoE routing ties, the sliced AdamW step;
* an LM train step on a 1x1 NCCL mesh against the same steps without one,
  and the dry-run's model of that step held to it.

They skip without a CUDA device; on a machine with an NVIDIA card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

A test whose failure could be a hang runs its work in a child process with
a time limit (``_in_child``).
"""
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline
from repro_torch.core.bitpack import unpack_bits
from repro_torch.graph import waves
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    device_plan,
    kernel_inputs,
    match_epochs,
    mega_inputs,
    resolve_stream_schedule,
    substream_match,
    waves_inputs,
)
from repro_torch.testing.cases import (
    WAVE,
    WINDOW,
    ZOO,
    at_offset,
    permuted_lanes,
    rmat_case,
    with_pad_bits,
)

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {**ZOO,
         "rmat10_L64": lambda: rmat_case(10, edge_factor=4, L=64, pad=3),
         "rmat10_L300": lambda: rmat_case(10, edge_factor=4, L=300, eps=0.01)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _on(case, device):
    stream = EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad, device=device)
    return stream, SubstreamConfig(n=case.n, L=case.L, eps=case.eps)


def _launched(before):
    """The kernel launches counted since ``before`` (a copy of
    ``build.launches``), by kernel name."""
    return {k: v - before.get(k, 0) for k, v in build.launches.items() if v != before.get(k, 0)}


def _in_child(name, timeout, *args):
    """``name(*args)``, a function of this module, in a process of its own
    that is killed after ``timeout`` seconds, so a launch that hangs fails
    its test instead of stalling the run; returns what it returned (JSON)."""
    code = ("import json, sys\n"
            f"sys.path[:0] = {[str(ROOT / 'tests'), str(ROOT / 'src'), str(ROOT)]!r}\n"
            "import test_torch_gpu as t\n"
            f"print(json.dumps(t.{name}(*json.loads(sys.argv[1]))))\n")
    torch.cuda.empty_cache()  # the child's room on the card
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(args)], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    args = kernel_inputs(*_on(CASES[case](), cuda))
    before = build.launches[kernel.NAME]
    assigned, mb = kernel.substream_match_packed(*args)
    assert build.launches[kernel.NAME] == before + 1
    want_a, want_mb = kernel.substream_match_packed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


def _wave_operands(schedule, stream, cfg, seg_block, mb0=None, packed=True):
    sch = resolve_stream_schedule(stream)
    if schedule == "mega":
        args, _ = mega_inputs(stream, cfg, sch, seg_block, mb0, packed)
        name = kernel.MEGA_NAME if packed else kernel.MEGA_UNPACKED_NAME
        launch, plain = kernel.substream_match_mega, kernel.substream_match_mega_plain
    else:
        args, _ = waves_inputs(stream, cfg, sch, mb0, packed)
        name = kernel.WAVES_NAME if packed else kernel.WAVES_UNPACKED_NAME
        launch, plain = kernel.substream_match_waves, kernel.substream_match_waves_plain
    return (name, functools.partial(launch, packed=packed), functools.partial(plain, packed=packed),
            args)


@pytest.mark.parametrize("schedule, seg_block", [("mega", 1), ("mega", 2), ("mega", 4), ("waves", None)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wave_kernels_match_plain_versions(cuda, case, schedule, seg_block):
    name, launch, plain, args = _wave_operands(schedule, *_on(CASES[case](), cuda), seg_block)
    before = build.launches[name]
    assigned, mb = launch(*args)
    assert build.launches[name] == before + 1
    want_a, want_mb = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


def _carried(case, device, packed=False):
    """The second half of ``case`` on ``device`` and the first half's bits
    from the plain scan: dense (bool [n, L]), or packed (uint8 [n, words])."""
    stream, cfg = _on(case, device)
    h = stream.num_edges // 2
    head, tail = (EdgeStream(*(t[sl] for t in (stream.src, stream.dst, stream.weight, stream.valid)))
                  for sl in (slice(0, h), slice(h, None)))
    res = substream_match(head, cfg, device="cpu", packed=packed)
    return tail, cfg, (res.mb_packed if packed else res.mb).to(device)


UNPACKED_CASES = {**CASES,
                  "rmat8_L13": lambda: rmat_case(8, edge_factor=4, L=13, pad=3),
                  "rmat8_L2048": lambda: rmat_case(8, edge_factor=4, L=2048, eps=0.002)}


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("case", sorted(UNPACKED_CASES))
def test_unpacked_kernel_matches_plain_version(cuda, case, carried):
    c = UNPACKED_CASES[case]()
    stream, cfg, mb0 = _carried(c, cuda) if carried else (*_on(c, cuda), None)
    args = kernel_inputs(stream, cfg, mb0, packed=False)
    before = build.launches[kernel.UNPACKED_NAME]
    assigned, mb = kernel.substream_match_unpacked(*args)
    assert build.launches[kernel.UNPACKED_NAME] == before + 1
    want_a, want_mb = kernel.substream_match_unpacked_plain(*args)
    torch.cuda.synchronize()
    assert mb.dtype == torch.int8
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


WINDOW_CASES = [f"{name}-L64" for name in sorted(WINDOW)] + [
    f"{name}-L{L}" for name in ("hub", "repeat_d33", "self_loops_mid") for L in (13, 65, 300, 2048)]


def _edge_kernel(packed):
    if packed:
        return kernel.NAME, kernel.substream_match_packed, kernel.substream_match_packed_plain
    return kernel.UNPACKED_NAME, kernel.substream_match_unpacked, kernel.substream_match_unpacked_plain


def _held_to_plain(packed, args):
    name, launch, plain = _edge_kernel(packed)
    before = build.launches[name]
    assigned, mb = launch(*args)
    assert build.launches[name] == before + 1
    want_a, want_mb = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_edge_kernels_on_window_cases(cuda, case, packed, carried):
    """Hubs, pairs 31 to 65 edges apart, self-loops inside a batch and
    m in {0, 1, 31, 32, 33}; L up to 2048 (32 column chunks)."""
    name, L = case.split("-L")
    c = WINDOW[name](int(L))
    stream, cfg, mb0 = _carried(c, cuda, packed) if carried else (*_on(c, cuda), None)
    _held_to_plain(packed, kernel_inputs(stream, cfg, mb0, packed=packed))


@pytest.mark.parametrize("packed", [True, False])
def test_edge_kernels_take_unaligned_operands(cuda, packed):
    """Edges and weights that start inside a 16-byte line (views at an
    offset) are staged word by word at the ends of each chunk."""
    c = rmat_case(10, edge_factor=4, L=64)
    edges, w, thr, n_pad, _ = kernel_inputs(*_on(c, cuda), packed=packed)
    for shift in (1, 2, 3):
        big_e = torch.zeros((edges.shape[0] + 4, 2), dtype=torch.int32, device=cuda)
        big_w = torch.zeros(w.shape[0] + 4, device=cuda)
        big_e[shift // 2 + 1 : shift // 2 + 1 + edges.shape[0]] = edges
        big_w[shift : shift + w.shape[0]] = w
        e_view = big_e[shift // 2 + 1 : shift // 2 + 1 + edges.shape[0]]
        w_view = big_w[shift : shift + w.shape[0]]
        assert w_view.data_ptr() % 16 and e_view.is_contiguous()
        _held_to_plain(packed, (e_view, w_view, thr, n_pad, None))


def test_packed_kernel_takes_a_row_of_two_words(cuda):
    """A packed width that is not a multiple of 8 (L = 13 called directly):
    the wrapper pads the block's rows and returns [n_pad, width]."""
    c = WINDOW["hub"](13)
    edges, w, thr, n_pad, _ = kernel_inputs(*_on(c, cuda))
    thr = thr[:, :2].contiguous()
    _held_to_plain(True, (edges, w, thr, n_pad, None))
    mb0 = torch.randint(0, 256, (n_pad, 2), dtype=torch.uint8, device=cuda)
    _held_to_plain(True, (edges, w, thr, n_pad, mb0))


def _rounds_held(args, model=True):
    """The rounds engine on ``args`` (card tensors) against the packed walker
    (row 1) and, where ``model``, the numpy model on the CPU: ``assigned``
    and the block bit for bit; the engine's stats are the model's."""
    from repro_torch.testing.rounds_model import rounds_model

    before = build.launches[kernel.ROUNDS_NAME], build.launches[kernel.ROUNDS_KEYS_NAME]
    stats = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    got_a, got_mb = kernel.substream_match_rounds(*args, stats=stats)
    slices = build.launches[kernel.ROUNDS_NAME] - before[0]
    assert slices == build.launches[kernel.ROUNDS_KEYS_NAME] - before[1]
    assert slices > 0 or args[0].shape[0] == 0
    want_a, want_mb = kernel.substream_match_packed(*args)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a)
    assert torch.equal(got_mb, want_mb)
    if model:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        m, n_pad = args[0].shape[0], args[3]
        geometry = kernel.rounds_geometry(m, n_pad, 0, kernel.rounds_blocks(args[0].device))
        m_a, m_mb, chunks, rounds = rounds_model(*cpu, geometry=geometry)
        np.testing.assert_array_equal(got_a.cpu().numpy(), m_a)
        np.testing.assert_array_equal(got_mb.cpu().numpy(), m_mb)
        assert stats.tolist() == [chunks, rounds]
    return stats.tolist()


ROUNDS_CASES = sorted(k for k in CASES if k != "rmat10_L300") + [
    f"{name}-L{L}" for name in sorted(WINDOW) for L in (1, 13, 64)]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("case", ROUNDS_CASES)
def test_rounds_engine_matches_walker_and_model(cuda, case, carried):
    """The zoo, RMAT, hubs, repeated pairs, self-loops, m in {0, 1, 31, 32,
    33}, L in {1, 13, 64}, with and without carried bits."""
    if "-L" in case:
        name, L = case.split("-L")
        c = WINDOW[name](int(L))
    else:
        c = CASES[case]()
    stream, cfg, mb0 = _carried(c, cuda, True) if carried else (*_on(c, cuda), None)
    _rounds_held(kernel_inputs(stream, cfg, mb0))


def test_rounds_engine_takes_unsorted_thresholds_and_a_short_row(cuda):
    from repro_torch.testing.cases import permuted_lanes

    c = rmat_case(12, edge_factor=8, L=64)
    edges, w, thr, n_pad, _ = kernel_inputs(*_on(c, cuda))
    _rounds_held((edges, w, permuted_lanes(thr, 64), n_pad, None))
    c = WINDOW["hub"](13)
    edges, w, thr, n_pad, _ = kernel_inputs(*_on(c, cuda))
    thr = thr[:, :2].contiguous()
    mb0 = torch.randint(0, 256, (n_pad, 2), dtype=torch.uint8, device=cuda)
    _rounds_held((edges, w, thr, n_pad, mb0))


def _bench_config(name):
    """A configuration file of the benchmark (``perfbench/configs``)."""
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def _blocked_args(src, dst, w, n, mb0=None):
    """The packed per-edge operands of a stream on the card in the main
    path's blocked order (K = 32), L = 64."""
    from repro_torch.core.blocked import lexicographic_order, permute_stream

    stream = EdgeStream(src, dst, w, torch.ones(src.shape, dtype=torch.bool, device=src.device))
    blocked = permute_stream(stream, lexicographic_order(stream, 32))
    return kernel_inputs(blocked, SubstreamConfig(n=n, L=64, eps=0.1), mb0)


@pytest.mark.parametrize("scale, edge_factor, model", [(16, 16, True), (20, 8, False)])
def test_rounds_engine_on_blocked_rmat(cuda, scale, edge_factor, model):
    """RMAT at 2^16 (1 M edges, eight chunks; also against the model) and
    2^20 (8 M edges) in the blocked order, whole and as two halves that
    carry their bits."""
    c = rmat_case(scale, edge_factor=edge_factor, L=64, seed=3)
    src, dst, w = (torch.from_numpy(x).to(cuda) for x in (c.src, c.dst, c.w))
    edges, wb, thr, n_pad, _ = _blocked_args(src, dst, w, c.n)
    chunks, rounds = _rounds_held((edges, wb, thr, n_pad, None), model=model)
    assert chunks == -(-edges.shape[0] // kernel.EDGE_ROUNDS_CHUNK) and rounds >= chunks
    h = edges.shape[0] // 2
    _, mb_head = kernel.substream_match_rounds(edges[:h], wb[:h], thr, n_pad)
    a_tail, mb_tail = kernel.substream_match_rounds(edges[h:], wb[h:], thr, n_pad, mb_head)
    want_a, want_mb = kernel.substream_match_packed(edges, wb, thr, n_pad)
    assert torch.equal(a_tail, want_a[h:]) and torch.equal(mb_tail, want_mb)


def test_rounds_engine_on_a_graph500_stream_out_of_the_l2(cuda):
    """A Graph500-form stream (scrambled labels, self-loops and repeats
    kept) on 2^23 vertices, whose 64 MiB block leaves the L2: 2^24 edges in
    the blocked order, against the walker, whole and from carried bits."""
    from perfbench.gen import graph500

    config = {**_bench_config("graph500-L64"), "edge_factor": 2}
    src, dst, w = graph500.generate(config, 23, torch.Generator(device=cuda).manual_seed(5))
    assert int((src == dst).sum()) > 0
    n = 1 << 23
    assert not device_plan(n, 64).fits_l2
    args = _blocked_args(src, dst, w, n)
    _rounds_held(args, model=False)
    edges, wb, thr, n_pad, _ = args
    h = edges.shape[0] // 3
    _, mb_head = kernel.substream_match_packed(edges[:h], wb[:h], thr, n_pad)
    _rounds_held((edges[h:], wb[h:], thr, n_pad, mb_head), model=False)


@pytest.mark.parametrize("budget", [0, 1 << 40])
@pytest.mark.parametrize("blocks", [None, 114, 7])
def test_rounds_engine_slices_and_grids(cuda, monkeypatch, budget, blocks):
    """The bits do not depend on how the engine cuts the stream: slices of
    the floor's two chunks or of the whole stream (the grouping's budget),
    and chunks for the card's resident grid, one of 114 CTAs (an H100
    PCIe's SMs) or of 7; the launches count one keys and one rounds launch
    a slice."""
    c = rmat_case(16, edge_factor=16, L=64, seed=8)
    src, dst, w = (torch.from_numpy(x).to(cuda) for x in (c.src, c.dst, c.w))
    args = _blocked_args(src, dst, w, c.n)
    m = args[0].shape[0]
    monkeypatch.setattr(kernel, "group_budget", lambda device: budget)
    if blocks is not None:
        monkeypatch.setattr(kernel, "rounds_blocks", lambda device: blocks)
    grid = blocks or kernel.rounds_blocks(cuda)
    chunk, slice_edges, _ = kernel.rounds_geometry(m, args[3], budget, grid)
    assert chunk == min(kernel.EDGE_ROUNDS_CHUNK, grid * 1024)
    before = build.launches[kernel.ROUNDS_NAME]
    chunks, _ = _rounds_held(args, model=False)
    assert chunks == -(-m // chunk)
    assert build.launches[kernel.ROUNDS_NAME] - before == -(-m // slice_edges)


def _blocked_bench_stream(workload, seed):
    """A job's stream of a benchmark cell, drawn on the card from ``seed``
    as the benchmark draws it (``"s16"``: kron48-L64 at 2^16 vertices;
    ``"g500"``: graph500-L64 at 2^23 vertices, 2^27 edges), as the packed
    per-edge operands of its blocked order."""
    from perfbench.gen import graph500, rmat

    name, scale, gen = {"s16": ("kron48-L64", 16, rmat),
                        "g500": ("graph500-L64", 23, graph500)}[workload]
    src, dst, w = gen.generate(_bench_config(name), scale,
                               torch.Generator(device="cuda").manual_seed(seed))
    return _blocked_args(src, dst, w, 1 << scale)


def _rounds_stress(workload, seed, calls):
    """``calls`` rounds-engine calls on one blocked benchmark stream in each
    slicing (the allocator's room, and a budget of 0: two chunks a slice):
    the slices of a call and how many calls differ from the walker's bits."""
    args = _blocked_bench_stream(workload, seed)
    want_a, want_mb = kernel.substream_match_packed(*args)
    out, room = {"m": int(args[0].shape[0])}, kernel.group_budget
    for label, budget in (("allocator", room), ("two_chunks", lambda device: 0)):
        kernel.group_budget = budget
        unequal = 0
        for _ in range(calls):
            before = build.launches[kernel.ROUNDS_NAME]
            a, mb = kernel.substream_match_rounds(*args)
            unequal += not (torch.equal(a, want_a) and torch.equal(mb, want_mb))
        out[label] = {"slices": build.launches[kernel.ROUNDS_NAME] - before, "unequal": unequal}
    kernel.group_budget = room
    return out


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("workload", ["s16", "g500"])
def test_rounds_engine_repeated_calls_on_card(cuda, workload, seed):
    """The rounds engine's loop exits decide by flags stamped with each
    round's epoch; a race there once put the grid barriers out of step, and
    a call hung. 40 calls in each slicing on the blocked stream of a
    benchmark cell: every call's bits are the walker's. The calls run in a
    process of their own, killed after 300 s, so a hang fails the test."""
    out = _in_child("_rounds_stress", 300, workload, seed, 40)
    assert out["allocator"]["slices"] >= 1 and out["two_chunks"]["slices"] > 1, out
    assert out["allocator"]["unequal"] == out["two_chunks"]["unequal"] == 0, out


@pytest.mark.parametrize("case", ["short_L64", "L128", "unpacked"])
def test_route_counters_on_card(cuda, case):
    """``substream_match`` on the card sends every packed call with rows of
    one 64-bit word to the rounds engine, however short its stream, and
    rows of two words and the unpacked layout to the walker: the route
    counters, the launch counts and the ``execute`` span's args say which;
    the bits are the CPU's."""
    from repro_torch import obs

    L, packed = {"short_L64": (64, True), "L128": (128, True), "unpacked": (64, False)}[case]
    c = rmat_case(6, edge_factor=2, L=L, eps=0.1 if L == 64 else 0.05, seed=12)
    stream, cfg = _on(c, cuda)
    assert stream.num_edges < 200
    build.load_library(kernel.EDGES_LIBRARY, kernel.EDGES_SOURCE)  # else the stage is compile
    tel = obs.Telemetry()
    before = dict(build.launches)
    got = substream_match(stream, cfg, packed=packed, telemetry=tel)
    want = substream_match(stream.to("cpu"), cfg, packed=packed, device="cpu")
    assert torch.equal(got.assigned.cpu(), want.assigned)
    assert torch.equal(got.mb.cpu(), want.mb)
    launched = _launched(before)
    (execute,) = [e for e in tel.tracer.events if e["name"] == "kernel_edges.execute"]
    if case == "short_L64":
        route = "rounds_engine"
        assert launched == {kernel.ROUNDS_NAME: 1, kernel.ROUNDS_KEYS_NAME: 1}
        assert execute["args"]["chunks"] == tel.counters.get("kernel_edges.chunks") == 1
        assert execute["args"]["rounds"] == tel.counters.get("kernel_edges.rounds") >= 1
    else:
        route = "walker"
        assert launched == {kernel.NAME if packed else kernel.UNPACKED_NAME: 1}
        assert "rounds" not in execute["args"]
    other = {"walker": "rounds_engine", "rounds_engine": "walker"}[route]
    assert tel.counters.get(f"kernel_edges.{route}.calls") == 1
    assert tel.counters.get(f"kernel_edges.{other}.calls") == 0


def test_rounds_engine_peak_under_the_blockings(cuda, monkeypatch):
    """On a kron48.s16-jobs-sized stream (2^16 vertices, ~2.4 M edges) the
    main path's peak while Part 1 runs on the rounds engine stays under the
    peak the blocking set before it."""
    from repro_torch.kernels.substream_match import ops

    c = rmat_case(16, edge_factor=48, L=64, seed=11)
    host, cfg = _on(c, "cpu")
    peaks = {}
    engine = ops._rounds_device

    def measured(args, stats=None):  # the peak is not reset: the engine reads its room from it
        torch.cuda.synchronize()
        peaks["before"] = torch.cuda.max_memory_allocated()
        out = engine(args, stats)
        torch.cuda.synchronize()
        peaks["part1"] = torch.cuda.max_memory_allocated()
        return out

    monkeypatch.setattr(ops, "_rounds_device", measured)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    idx, _ = mwm_pipeline(host, cfg, part1="kernel")
    monkeypatch.setattr(ops, "edges_route", lambda *a: "walker")
    want, _ = mwm_pipeline(host, cfg, part1="kernel")
    np.testing.assert_array_equal(idx, want)
    assert host.num_edges > 2_000_000
    assert peaks["part1"] <= peaks["before"], peaks


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("schedule, seg_block", [("mega", 1), ("mega", 2), ("waves", None)])
@pytest.mark.parametrize("case", sorted(UNPACKED_CASES))
def test_unpacked_wave_kernels_match_plain_versions(cuda, case, schedule, seg_block, carried):
    c = UNPACKED_CASES[case]()
    stream, cfg, mb0 = _carried(c, cuda) if carried else (*_on(c, cuda), None)
    name, launch, plain, args = _wave_operands(schedule, stream, cfg, seg_block, mb0, packed=False)
    before = build.launches[name]
    assigned, mb = launch(*args)
    assert build.launches[name] == before + 1
    want_a, want_mb = plain(*args)
    torch.cuda.synchronize()
    assert mb.dtype == torch.int8
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


def _held_to_plain_and_edges_kernel(stream, cfg, sch, schedule, seg_block, mb0, mb0_packed,
                                    packed):
    """The wave kernel on ``stream`` under ``sch`` in one layout: equal to
    its plain version on the same operands, and, scattered to the stream, to
    the packed per-edge kernel on the stream's order (other code). A carried
    unpacked block has its set bytes made 5; a carried packed one random bits
    past L and past n, which come back unchanged."""
    if schedule == "mega":
        args, slots = mega_inputs(stream, cfg, sch, seg_block, mb0, packed=packed)
        name, launch, plain = ((kernel.MEGA_NAME if packed else kernel.MEGA_UNPACKED_NAME),
                               kernel.substream_match_mega, kernel.substream_match_mega_plain)
    else:
        args, slots = waves_inputs(stream, cfg, sch, mb0, packed=packed)
        name, launch, plain = ((kernel.WAVES_NAME if packed else kernel.WAVES_UNPACKED_NAME),
                               kernel.substream_match_waves, kernel.substream_match_waves_plain)
    mask = None
    if args[-1] is not None and packed:
        carried, mask = with_pad_bits(args[-1], cfg.n, cfg.L)
        args = (*args[:-1], carried)
    elif args[-1] is not None:
        args = (*args[:-1], args[-1] * 5)
    before = build.launches[name]
    assigned, mb = launch(*args, packed=packed)
    assert build.launches[name] == before + 1
    want_a, want_mb = plain(*args, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)
    if mask is not None:
        n_pad = mb.shape[0]
        assert torch.equal(mb & mask[:n_pad], args[-1][:n_pad] & mask[:n_pad])
    edges = substream_match(stream, cfg, mb0=mb0_packed, packed=True)
    assert torch.equal(waves.scatter_slot_assignments(slots, assigned, stream.num_edges),
                       edges.assigned)
    dense = unpack_bits(mb, 8 * mb.shape[1]) if packed else mb.ne(0)
    assert torch.equal(dense[: cfg.n, : cfg.L], edges.mb)


RING_CASES = [f"{name}-L{L}" for name in sorted(WAVE) for L in (64, 300, 2048)]


def _ring_case(case, cuda, carried, packed):
    name, L = case.split("-L")
    c = WAVE[name](int(L))
    if carried:
        stream, cfg, mb0_packed = _carried(c, cuda, packed=True)
        mb0 = mb0_packed if packed else _carried(c, cuda)[2]
    else:
        (stream, cfg), mb0, mb0_packed = _on(c, cuda), None, None
    sch = resolve_stream_schedule(stream)
    return stream, cfg, sch, mb0, mb0_packed


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("schedule, seg_block", [("mega", 1), ("mega", 2), ("mega", 4), ("waves", None)])
@pytest.mark.parametrize("case", RING_CASES)
def test_unpacked_wave_kernels_on_ring_cases(cuda, case, schedule, seg_block, carried):
    """Two waves of 5,000 edges (wider than the ring and than one pass), a
    star of 3,000 leaves (3,000 one-edge waves), waves crossing the ring's
    capacity both ways; rows of 64, 304 and 2048 bytes."""
    stream, cfg, sch, mb0, mb0_packed = _ring_case(case, cuda, carried, packed=False)
    _held_to_plain_and_edges_kernel(stream, cfg, sch, schedule, seg_block, mb0, mb0_packed,
                                    packed=False)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("schedule, seg_block", [("mega", 1), ("mega", 2), ("mega", 4), ("waves", None)])
@pytest.mark.parametrize("case", RING_CASES)
def test_packed_wave_kernels_on_ring_cases(cuda, case, schedule, seg_block, carried):
    """The same streams on the packed block walked in place: rows of 8, 40
    and 256 bytes."""
    stream, cfg, sch, mb0, mb0_packed = _ring_case(case, cuda, carried, packed=True)
    _held_to_plain_and_edges_kernel(stream, cfg, sch, schedule, seg_block, mb0, mb0_packed,
                                    packed=True)


def test_unpacked_waves_kernel_takes_unsorted_thresholds(cuda):
    """Threshold lanes in any order: the kernel stages no passing count and
    compares every lane inline."""
    for case in (rmat_case(10, edge_factor=4, L=64), WAVE["mixed"](300)):
        stream, cfg = _on(case, cuda)
        args, _ = waves_inputs(stream, cfg, resolve_stream_schedule(stream), packed=False)
        moved = (*args[:2], permuted_lanes(args[2], cfg.L), *args[3:])
        assigned, mb = kernel.substream_match_waves(*moved, packed=False)
        want_a, want_mb = kernel.substream_match_waves_plain(*moved, packed=False)
        torch.cuda.synchronize()
        assert torch.equal(assigned, want_a)
        assert torch.equal(mb, want_mb)


def test_packed_waves_kernel_takes_unsorted_bit_planes(cuda):
    """Bit planes whose lanes are in any order, with a carried block too."""
    for case in (rmat_case(10, edge_factor=4, L=64), WAVE["mixed"](300), WAVE["wide"](2048)):
        for carried in (False, True):
            stream, cfg, mb0 = _carried(case, cuda, True) if carried else (*_on(case, cuda), None)
            args, _ = waves_inputs(stream, cfg, resolve_stream_schedule(stream), mb0)
            moved = (*args[:2], permuted_lanes(args[2], cfg.L), *args[3:])
            assigned, mb = kernel.substream_match_waves(*moved)
            want_a, want_mb = kernel.substream_match_waves_plain(*moved)
            torch.cuda.synchronize()
            assert torch.equal(assigned, want_a)
            assert torch.equal(mb, want_mb)


def _unaligned(cuda, schedule, packed):
    """Slot ids and weights that start inside a 16-byte line (views 4, 8
    and 12 bytes past it): the ring is filled 4 bytes a copy; and a carried
    block that starts 3, 5 or 7 bytes past a word, which the wrapper copies
    into place. Each equal to the plain version on aligned operands."""
    c = rmat_case(10, edge_factor=4, L=64)
    stream, cfg, mb0 = _carried(c, cuda, packed)
    sch = resolve_stream_schedule(stream)
    if schedule == "mega":
        args, _ = mega_inputs(stream, cfg, sch, 2, mb0, packed)
        launch, plain = kernel.substream_match_mega, kernel.substream_match_mega_plain
    else:
        args, _ = waves_inputs(stream, cfg, sch, mb0, packed)
        launch, plain = kernel.substream_match_waves, kernel.substream_match_waves_plain
    want_a, want_mb = plain(*args, packed=packed)
    for shift in (1, 2, 3):
        ids, w, block = at_offset(args[0], shift), at_offset(args[1], shift), at_offset(
            args[-1], 2 * shift + 1)
        assert ids.data_ptr() % 16 and w.data_ptr() % 16 and block.data_ptr() % 8
        assigned, mb = launch(ids, w, *args[2:-1], block, packed=packed)
        torch.cuda.synchronize()
        assert torch.equal(assigned, want_a)
        assert torch.equal(mb, want_mb)


@pytest.mark.parametrize("schedule", ["mega", "waves"])
def test_unpacked_wave_kernels_take_unaligned_operands(cuda, schedule):
    _unaligned(cuda, schedule, packed=False)


@pytest.mark.parametrize("schedule", ["mega", "waves"])
def test_packed_wave_kernels_take_unaligned_operands(cuda, schedule):
    _unaligned(cuda, schedule, packed=True)


@pytest.mark.parametrize("name", kernel.WAVE_NAMES)
def test_wave_launch_refuses_a_misaligned_block(cuda, name):
    """The walk moves whole 64-bit words of the block (16-byte pieces
    unpacked): a block pointer off that alignment is refused before any
    launch (cudaErrorInvalidValue), not read torn."""
    packed = name in (kernel.MEGA_NAME, kernel.WAVES_NAME)
    mega = name in (kernel.MEGA_NAME, kernel.MEGA_UNPACKED_NAME)
    width, rows, total = (8 if packed else 64), 16, 8
    block = torch.zeros(rows * width + 16, dtype=torch.uint8, device=cuda)
    ids = torch.zeros(2 * total, dtype=torch.int32, device=cuda)  # self-loops on row 0
    w = torch.ones(total, device=cuda)
    thr = torch.full((8 * width if packed else width,), float("inf"), device=cuda)
    offs = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    work = torch.empty((rows, 1), dtype=torch.int64, device=cuda)
    counts = torch.empty(total, dtype=torch.int32, device=cuda)
    assigned = torch.full((total,), -1, dtype=torch.int32, device=cuda)
    fn = kernel._waves_launcher(name)
    for lead in (0, 4):
        ptrs = [ids.data_ptr(), w.data_ptr(), thr.data_ptr(), block.data_ptr() + lead,
                *([] if packed else [work.data_ptr()]), counts.data_ptr(), assigned.data_ptr()]
        err = fn(offs.data_ptr(), 1, total, *((total,) if mega else ()), *ptrs, total, rows,
                 width, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert (err != 0) == (lead != 0), (lead, err)
    assert not block.any() and bool((assigned == -1).all())


@pytest.mark.parametrize("engine", ["edges", "waves", "mega"])
@pytest.mark.parametrize("packed", [True, False])
def test_epochs_on_card_match_cpu(cuda, engine, packed):
    """Three epochs on the card equal the CPU's, each epoch one call of the
    engine's kernel (packed ``edges``: the rounds engine, one keys and one
    rounds launch a slice); resumed from the state after epoch 0, the card
    runs epochs 1 and 2 alone and ends with the same bits."""
    c = CASES["rmat10_L64"]()
    stream, cfg = _on(c, cuda)
    states = {}
    before = dict(build.launches)
    got = match_epochs(stream, cfg, epochs=3, engine=engine, packed=packed,
                       epoch_hook=states.__setitem__)
    launched = _launched(before)
    want = match_epochs(*_on(c, "cpu"), epochs=3, engine="scan", packed=packed, device="cpu")
    assert got.is_packed == packed
    assert torch.equal(got.assigned.cpu(), want.assigned)
    assert torch.equal(got.mb.cpu(), want.mb)
    if engine == "edges" and packed:
        slices = launched.get(kernel.ROUNDS_NAME, 0)
        assert slices >= 3 and launched == {kernel.ROUNDS_NAME: slices,
                                            kernel.ROUNDS_KEYS_NAME: slices}
    else:
        name = kernel.UNPACKED_NAME if engine == "edges" else _wave_kernel_name(engine, packed)
        assert launched == {name: 3}
    ran = []
    again = match_epochs(stream, cfg, epochs=3, engine=engine, packed=packed, state=states[0],
                         epoch_hook=lambda k, st: ran.append(k))
    assert ran == [1, 2]
    assert torch.equal(again.assigned, got.assigned) and torch.equal(again.mb, got.mb)


@pytest.mark.parametrize("kw", [{}, {"schedule": "waves"}, {"schedule": "mega"},
                                {"packed": False}, {"schedule": "waves", "packed": False},
                                {"schedule": "mega", "packed": False}])
@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "rmat10_L64"])
def test_pipeline_on_card_matches_cpu(cuda, case, kw):
    """The blocked order through each Part-1 kernel gives the CPU's edges
    pipeline's matching; a wave schedule launches its wave kernel."""
    c = CASES[case]()
    before = dict(build.launches)
    idx, weight = mwm_pipeline(*_on(c, cuda), part1="kernel", **kw)
    want_idx, want_weight = mwm_pipeline(*_on(c, "cpu"), part1="kernel", device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_weight
    if "schedule" in kw:
        assert _launched(before).get(_wave_kernel_name(kw["schedule"], kw.get("packed", True)), 0) >= 1


def test_kernel_refuses_what_it_cannot_take(cuda):
    edges = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_packed(edges, w, torch.ones((8, kernel.MAX_WIDTH + 8), device=cuda), 8)
    with pytest.raises(ValueError, match="weights on cpu"):
        kernel.substream_match_packed(edges, w.cpu(), torch.ones((8, 8), device=cuda), 8)
    offs = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_waves(torch.zeros((8, 2), dtype=torch.int32, device=cuda),
                                     torch.ones(8, device=cuda),
                                     torch.ones((8, 12), device=cuda), offs, 8, 8)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_unpacked(edges, w, torch.ones((1, 24), device=cuda), 8)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_unpacked(
            edges, w, torch.ones((1, kernel.MAX_UNPACKED_WIDTH + 16), device=cuda), 8)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_waves(torch.zeros((8, 2), dtype=torch.int32, device=cuda),
                                     torch.ones(8, device=cuda),
                                     torch.ones((1, 24), device=cuda), offs, 8, 8, packed=False)


# --------------------------------------------------------------------------
# The robustness and observability layers on the card.


@pytest.mark.parametrize("ones", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", sorted(WINDOW))
def test_edge_kernels_at_L1(cuda, name, packed, carried, ones):
    """One substream: one lane, one CTA, the threshold 1 and +inf pads, a
    packed row of 8 bytes; with every weight 1 (``ones``) it is the shape
    ``merge_device`` launches."""
    c = WINDOW[name](1)
    if ones:
        c = c._replace(w=np.ones_like(c.w))
    stream, cfg, mb0 = _carried(c, cuda, packed) if carried else (*_on(c, cuda), None)
    args = kernel_inputs(stream, cfg, mb0, packed=packed)
    assert args[2].shape == ((8, 8) if packed else (1, 16))
    _held_to_plain(packed, args)


def _part1_on_cpu(c):
    from repro_torch.core import mwm_scan

    stream, cfg = _on(c, "cpu")
    return stream, cfg, mwm_scan(stream, cfg, device="cpu")


@pytest.mark.parametrize("case", ["rmat10_L64", "rmat10_L300", "star", "duplicates", "empty"])
def test_merge_device_on_card_equals_merge_host(cuda, case):
    from repro_torch.core import MatchingResult, merge_host
    from repro_torch.kernels.substream_match.ops import merge_device

    stream, cfg, res = _part1_on_cpu(CASES[case]())
    want = merge_host(stream, res, cfg)
    on_card = MatchingResult(res.assigned.to(cuda), mb=res.mb.to(cuda))
    before = build.launches[kernel.NAME]
    mask = merge_device(stream.to(cuda), on_card, cfg)
    assert mask.device.type == "cuda" and mask.dtype == torch.bool
    np.testing.assert_array_equal(torch.nonzero(mask).flatten().cpu().numpy(), want)
    recorded = int((res.assigned >= 0).sum())
    assert build.launches[kernel.NAME] == before + (1 if recorded else 0)


#: faults injected as plan refusals (the one failure the card's ladder
#: absorbs), schedule, and the kernel rung that delivers (None: the ladder
#: is exhausted); "launch_error" injects a failure that is no refusal
LADDER_FAULTS = {
    "mega_launch": (("mega_device",), "mega", "waves"),
    "mega_plan": (("mega_plan",), "mega", "waves"),
    "mega_and_waves": (("mega_device", "waves_device"), "mega", None),
    "waves_launch": (("waves_device",), "waves", None),
    "edges_launch": (("edges_device",), "edges", None),
    "launch_error": (("mega_device",), "mega", None),
}


def _wave_kernel_name(schedule, packed):
    if schedule == "mega":
        return kernel.MEGA_NAME if packed else kernel.MEGA_UNPACKED_NAME
    return kernel.WAVES_NAME if packed else kernel.WAVES_UNPACKED_NAME


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fault", sorted(LADDER_FAULTS))
def test_ladder_rungs_on_card(cuda, fault, packed):
    """On the card the ladder holds only kernel rungs and steps down only on
    a plan refusal: it ends in a kernel's bits or in FallbackExhaustedError,
    and any other failure propagates with no fallback event."""
    from repro_torch import obs
    from repro_torch.kernels.substream_match.ops import FallbackExhaustedError, PlanRefusedError
    from repro_torch.testing import faultline

    targets, schedule, delivered = LADDER_FAULTS[fault]
    c = CASES["rmat10_L64"]()
    _, _, want = _part1_on_cpu(c)
    stream, cfg = _on(c, cuda)
    tel = obs.Telemetry()
    before = dict(build.launches)
    exc_type = faultline.InjectedFailure if fault == "launch_error" else PlanRefusedError
    kw = dict(schedule=schedule, packed=packed, on_plan_failure="fallback", telemetry=tel)
    with faultline.failing(*targets, exc_type=exc_type):
        if delivered is not None:
            got = substream_match(stream, cfg, **kw)
        else:
            with pytest.raises(FallbackExhaustedError if exc_type is PlanRefusedError
                               else faultline.InjectedFailure):
                substream_match(stream, cfg, **kw)
    events = [e for e in tel.events if e["name"] == "fallback"]
    assert tel.counters.get("fallback.count") == len(events)
    assert not [r for r in tel.match_calls if r.engine in ("waves_xla", "scan")]
    launched = {k for k, v in build.launches.items() if v != before.get(k, 0)}
    if delivered is None:
        assert launched == set() and bool(events) == (exc_type is PlanRefusedError)
        return
    assert got.assigned.device.type == "cuda"
    assert torch.equal(got.assigned.cpu(), want.assigned) and torch.equal(got.mb.cpu(), want.mb)
    name = _wave_kernel_name(delivered, packed)
    assert events and build.launches[name] == before.get(name, 0) + 1 and launched == {name}


@pytest.mark.parametrize("packed", [True, False])
def test_ladder_steps_down_once_on_card(cuda, packed):
    """The mega kernel's plan refused once: the next rung, mega at
    seg_block 1, delivers the CPU's bits with the same kernel, after one
    fallback event."""
    from repro_torch import obs
    from repro_torch.kernels.substream_match.ops import PlanRefusedError
    from repro_torch.testing import faultline

    c = CASES["rmat10_L64"]()
    _, _, want = _part1_on_cpu(c)
    stream, cfg = _on(c, cuda)
    tel = obs.Telemetry()
    before = dict(build.launches)
    with faultline.flaky("mega_device", times=1, exc_type=PlanRefusedError):
        got = substream_match(stream, cfg, schedule="mega", packed=packed,
                              on_plan_failure="fallback", telemetry=tel)
    assert torch.equal(got.assigned.cpu(), want.assigned) and torch.equal(got.mb.cpu(), want.mb)
    assert tel.counters.get("fallback.count") == 1
    assert _launched(before) == {_wave_kernel_name("mega", packed): 1}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_clean_ladder_on_card(cuda, schedule, packed):
    from repro_torch import obs

    c = CASES["rmat10_L64"]()
    _, _, want = _part1_on_cpu(c)
    tel = obs.Telemetry()
    name = (kernel.ROUNDS_NAME if packed else kernel.UNPACKED_NAME) if schedule == "edges" \
        else _wave_kernel_name(schedule, packed)
    before = build.launches[name]
    got = substream_match(*_on(c, cuda), schedule=schedule, packed=packed,
                          on_plan_failure="fallback", telemetry=tel)
    assert torch.equal(got.assigned.cpu(), want.assigned) and torch.equal(got.mb.cpu(), want.mb)
    assert tel.counters.get("fallback.count") == 0 and build.launches[name] == before + 1
    rec, = tel.match_calls
    assert (rec.engine, rec.backend, rec.interpret) == (f"kernel_{schedule}", "cuda", False)
    assert rec.counters["fallback.count"] == 0


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_ladder_at_L2049_on_card(cuda, schedule, packed):
    """One past the widest row the kernels take: every kernel rung refuses
    it before a launch, and the ladder ends in FallbackExhaustedError (no
    plain version stands in for a kernel on the card)."""
    from repro_torch import obs
    from repro_torch.kernels.substream_match.ops import (
        FallbackExhaustedError, _fallback_attempts,
    )

    c = rmat_case(7, edge_factor=4, L=2049, eps=0.002, seed=9)
    tel = obs.Telemetry()
    before = sum(build.launches.values())
    with pytest.raises(FallbackExhaustedError) as exc:
        substream_match(*_on(c, cuda), schedule=schedule, packed=packed,
                        on_plan_failure="fallback", telemetry=tel)
    labels = [label for _, _, label in _fallback_attempts(schedule, None, on_card=True)]
    assert [label for label, _ in exc.value.attempts] == labels
    events = [e for e in tel.events if e["name"] == "fallback"]
    assert len(events) == len(labels) and all("width" in e["reason"] for e in events)
    assert sum(build.launches.values()) == before


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_telemetry_records_on_card(cuda, schedule, packed):
    from repro_torch import obs

    c = CASES["rmat10_L300"]()
    tel = obs.Telemetry()
    got = substream_match(*_on(c, cuda), schedule=schedule, packed=packed, telemetry=tel)
    plain = substream_match(*_on(c, cuda), schedule=schedule, packed=packed)
    assert torch.equal(got.assigned, plain.assigned) and torch.equal(got.mb, plain.mb)
    rec, = tel.match_calls
    assert (rec.backend, rec.interpret) == ("cuda", False)
    assert obs.consistency_problems(rec.stage_seconds, rec.wall_seconds) == []
    assert rec.device_seconds > 0
    assert [e["backend"] for e in tel.events if e["name"] == "substream_match.backend"] == ["cuda"]


def test_pipeline_spans_on_card(cuda):
    """The main path's spans on the card from a stream in pinned host
    memory: the same matching with telemetry on and off, the stream copied
    to the card once (one ``stream.to``, from ``cpu`` to the card by its
    index), Part 1's device stage (with the edges and the bit block), Part 2
    on the card (``merge.device`` holding ``merge.order`` and
    ``merge.greedy`` with its ``merge.kernel``, then ``merge.d2h`` of the
    matched int64 indices; no ``merge.host``), and the same tree in the
    profiler's trace. The main path's launches: Part 1 on the rounds engine
    (one keys and one rounds launch a slice, its route counted once, the
    walker's never) and the merge's one walker launch (row 1 at L = 1),
    nothing else; one ``kernel_edges`` record whose stages hold together."""
    import json
    import tempfile

    from repro_torch import obs

    c = CASES["rmat10_L64"]()
    host, cfg = _on(c, "cpu")
    pinned = EdgeStream(*(t.pin_memory() for t in (host.src, host.dst, host.weight,
                                                     host.valid)))
    want = mwm_pipeline(pinned, cfg, part1="kernel")
    tel = obs.Telemetry()
    before = dict(build.launches)
    got = mwm_pipeline(pinned, cfg, part1="kernel", telemetry=tel)
    launched = _launched(before)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    slices = launched.get(kernel.ROUNDS_NAME, 0)
    assert slices >= 1 and launched == {kernel.ROUNDS_NAME: slices,
                                        kernel.ROUNDS_KEYS_NAME: slices, kernel.NAME: 1}
    spans = [e for e in tel.tracer.events if e["ph"] == "X"]
    assert [e["args"] for e in spans if e["name"] == "stream.to"] == [
        {"bytes": pinned.nbytes, "source": "cpu", "target": f"cuda:{torch.cuda.current_device()}"},
    ]
    names = [e["name"] for e in spans]
    assert names[-1] == "pipeline" and "kernel_edges.execute" in names
    assert "merge.host" not in names
    merge = names[names.index("merge.order"):names.index("merge.d2h") + 1]
    assert merge == ["merge.order", "merge.kernel", "merge.greedy", "merge.device", "merge.d2h"]
    device = spans[names.index("merge.device")]
    for inner, outer in (("merge.order", device), ("merge.greedy", device),
                         ("merge.kernel", spans[names.index("merge.greedy")])):
        e = spans[names.index(inner)]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    block = {"bit_block_bytes": device_plan(cfg.n, cfg.L).nbytes, "fits_l2": 1}
    assert spans[names.index("kernel_edges.execute")]["args"] == {
        "edges": pinned.num_edges, **block, "chunks": tel.counters.get("kernel_edges.chunks"),
        "rounds": tel.counters.get("kernel_edges.rounds")}
    assert tel.counters.get("kernel_edges.rounds_engine.calls") == 1
    assert tel.counters.get("kernel_edges.walker.calls") == 0
    assert spans[names.index("merge.kernel")]["args"] == {
        "recorded": tel.counters.get("merge.recorded_edges"),
        "bit_block_bytes": device_plan(cfg.n, 1).nbytes, "fits_l2": 1}
    assert spans[names.index("merge.d2h")]["args"] == {"bytes": 8 * len(got[0])}
    assert tel.counters.get("merge.device.calls") == 1
    assert tel.counters.get("merge.host.calls") == 0
    assert tel.counters.get("merge.matched_edges") == len(got[0])
    rec, = tel.match_calls
    assert (rec.engine, rec.backend) == ("kernel_edges", "cuda")
    assert obs.consistency_problems(rec.stage_seconds, rec.wall_seconds) == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        mwm_pipeline(pinned, cfg, part1="kernel")
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/t.json")
        with open(f"{tmp}/t.json") as f:
            events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
              if e.get("cat") == "user_annotation" and e["name"].startswith("repro_torch/")]
    assert sorted(ranges) == sorted(f"repro_torch/{n}" for n in names)


def test_a_stream_on_the_card_is_not_copied_again(cuda):
    """A card has one name: ``None`` and ``"cuda"`` resolve to the current
    card by its index, the device its tensors carry, so ``mwm_blocked`` and
    ``substream_match`` on a stream already there record no ``stream.to``."""
    from repro_torch import obs
    from repro_torch.core import mwm_blocked
    from repro_torch.core.types import resolve_device

    stream, cfg = _on(CASES["rmat10_L64"](), cuda)
    assert resolve_device(None) == resolve_device("cuda") == stream.device
    assert stream.to("cuda") is stream
    tel = obs.Telemetry()
    mwm_blocked(stream, cfg, backend="kernel", telemetry=tel)
    substream_match(stream, cfg, telemetry=tel)
    names = [e["name"] for e in tel.tracer.events]
    assert "kernel_edges.execute" in names and "stream.to" not in names


@pytest.mark.parametrize("part1", ["scan", "waves", "blocked", "rounds"])
def test_every_part1_merges_on_the_card(cuda, part1):
    """Every ``part1`` on the card merges there (``merge_device`` once, no
    ``merge_host``) and returns the CPU's indices and weight."""
    from repro_torch import obs

    c = CASES["bipartite"]()
    tel = obs.Telemetry()
    idx, weight = mwm_pipeline(*_on(c, "cpu"), part1=part1, device=cuda, telemetry=tel)
    want_idx, want_weight = mwm_pipeline(*_on(c, "cpu"), part1=part1, device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_weight
    assert tel.counters.get("merge.device.calls") == 1
    assert tel.counters.get("merge.host.calls") == 0


def test_merge_peak_within_part1s_on_card(cuda):
    """Part 2 on the card holds no more device memory than Part 1 did: the
    peak over ``merge_device`` (the stream and ``assigned`` live, plus the
    merge's R-sized arrays) is at most the peak over ``mwm_blocked``, on an
    RMAT graph of scale 14."""
    from repro_torch.core import merge_host, mwm_blocked
    from repro_torch.kernels.substream_match.ops import merge_device

    c = rmat_case(14, edge_factor=16, L=64, seed=7)
    host, cfg = _on(c, "cpu")
    stream = host.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = mwm_blocked(stream, cfg, backend="kernel", device=cuda)
    torch.cuda.synchronize()
    part1 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mask = merge_device(stream, res, cfg, device=cuda)
    torch.cuda.synchronize()
    merge = torch.cuda.max_memory_allocated()
    assert merge <= part1, (merge, part1)
    np.testing.assert_array_equal(torch.nonzero(mask).flatten().cpu().numpy(),
                                  merge_host(stream, res, cfg))


@pytest.mark.parametrize("policy", ["strict", "sanitize"])
def test_validate_on_card_matches_cpu(cuda, policy):
    from repro_torch.core import StreamValidationError, validate_stream
    from repro_torch.testing import faultline

    c = CASES["rmat10_L64"]()
    cpu_stream, cfg = _on(c, "cpu")
    clean = cpu_stream.to(cuda)
    out, report = validate_stream(clean, cfg.n, policy=policy)
    assert out is clean and report.ok and report.num_valid_in == int(clean.valid.sum())
    dirty, _ = faultline.poison_weights(cpu_stream, (1, 7, 99), "nan")
    dirty, _ = faultline.poison_ids(dirty, cfg.n, (5, 500), "sacrificial")
    if policy == "strict":
        with pytest.raises(StreamValidationError) as want:
            validate_stream(dirty, cfg.n, policy=policy)
        with pytest.raises(StreamValidationError) as got:
            validate_stream(dirty.to(cuda), cfg.n, policy=policy)
        assert str(got.value) == str(want.value)
        return
    want, want_report = validate_stream(dirty, cfg.n, policy=policy)
    got, report = validate_stream(dirty.to(cuda), cfg.n, policy=policy)
    assert got.src.device.type == "cuda" and report == want_report
    for a, b in zip((got.src, got.dst, got.weight, got.valid),
                    (want.src, want.dst, want.weight, want.valid)):
        assert torch.equal(a.cpu(), b)


def test_snapshots_and_guard_around_epochs_on_card(cuda, tmp_path):
    """``match_epochs(engine="edges", packed=False)`` on the card with a
    snapshot per epoch: killed after epoch 1, resumed from disk with one
    transient flake retried by the guard; equal to the one-shot run."""
    from repro_torch import obs
    from repro_torch.checkpoint import SnapshotManager
    from repro_torch.core import ExecutionGuard
    from repro_torch.testing import faultline

    c = CASES["rmat10_L64"]()
    stream, cfg = _on(c, cuda)
    one = substream_match(stream, cfg, packed=False)
    kw = dict(epochs=4, engine="edges", packed=False)
    with pytest.raises(faultline.SimulatedCrash):  # a synchronous writer: epochs 0, 1 on disk
        match_epochs(stream, cfg, snapshots=SnapshotManager(tmp_path, async_save=False),
                     epoch_hook=faultline.kill_at_epoch(1), **kw)
    clk = faultline.FakeClock()
    tel = obs.Telemetry()
    guard = ExecutionGuard(retries=2, clock=clk, sleep=clk.sleep, telemetry=tel)
    before = build.launches[kernel.UNPACKED_NAME]
    with faultline.flaky("edges_device", times=1):
        got = match_epochs(stream, cfg, snapshots=SnapshotManager(tmp_path, telemetry=tel),
                           guard=guard, telemetry=tel, **kw)
    assert torch.equal(got.assigned, one.assigned) and torch.equal(got.mb, one.mb)
    assert [e["epoch"] for e in tel.events if e["name"] == "epoch.index"] == [2, 3]
    assert tel.counters.get("guard.retry") == 1 and clk.sleeps == [0.05]
    assert tel.counters.get("snapshot.restore.count") == 1
    assert build.launches[kernel.UNPACKED_NAME] == before + 2


def test_lost_snapshot_write_is_replayed_on_card(cuda, tmp_path):
    """``match_epochs(engine="edges", packed=False)`` on the card, killed
    after epoch 2 while the async writer still holds that epoch's snapshot
    and the power fails inside its commit: the directory holds epochs 0 and
    1, and the resume replays epochs 2 and 3, equal to the one-shot run."""
    from repro_torch import obs
    from repro_torch.checkpoint import SnapshotManager
    from repro_torch.kernels.substream_match.ops import epoch_bounds
    from repro_torch.testing import faultline

    stream, cfg = _on(CASES["rmat10_L64"](), cuda)
    one = substream_match(stream, cfg, packed=False)
    kw = dict(epochs=4, engine="edges", packed=False)
    lost = SnapshotManager(tmp_path, keep=0)
    commit, commits = lost.manager._commit, []

    def power_fails_in_third_commit(tmp_dir, final):
        commits.append(final)
        if len(commits) == 3:
            raise faultline.SimulatedCrash(f"killed mid-snapshot before rename of {tmp_dir}")
        commit(tmp_dir, final)

    lost.manager._commit = power_fails_in_third_commit
    with pytest.raises(faultline.SimulatedCrash):
        match_epochs(stream, cfg, snapshots=lost, epoch_hook=faultline.kill_at_epoch(2), **kw)
    with pytest.raises(faultline.SimulatedCrash, match="mid-snapshot"):
        lost.wait()
    assert SnapshotManager(tmp_path).all_positions() == epoch_bounds(stream.num_edges, 4)[1:3]
    tel = obs.Telemetry()
    got = match_epochs(stream, cfg, snapshots=SnapshotManager(tmp_path, telemetry=tel),
                       telemetry=tel, **kw)
    assert torch.equal(got.assigned, one.assigned) and torch.equal(got.mb, one.mb)
    assert [e["epoch"] for e in tel.events if e["name"] == "epoch.index"] == [2, 3]


# --------------------------------------------------------------------------
# The parallel-rounds engines, G-SEQ and the graph substrate on the card.


@pytest.mark.parametrize("blocked", [False, True])
def test_rounds_on_card_match_cpu(cuda, blocked):
    """``mwm_rounds`` at scale 12 (L = 64) on the card equals the CPU run
    and the packed per-edge kernel, in the generated and the blocked order;
    in chunks too."""
    from repro_torch.core import lexicographic_order, mwm_rounds, permute_stream
    from repro_torch.core import rounds as rounds_mod

    c = rmat_case(12, edge_factor=8, L=64, pad=5)
    stream, cfg = _on(c, "cpu")
    if blocked:
        stream = permute_stream(stream, lexicographic_order(stream, 32))
    want = mwm_rounds(stream, cfg, device="cpu")
    got = mwm_rounds(stream.to(cuda), cfg, packed=True)
    assert got.assigned.device.type == "cuda"
    assert torch.equal(got.assigned.cpu(), want.assigned) and torch.equal(got.mb.cpu(), want.mb)
    edges = substream_match(stream.to(cuda), cfg)
    assert torch.equal(edges.assigned, got.assigned) and torch.equal(edges.mb_packed, got.mb_packed)
    old = rounds_mod.CHUNK_ELEMENTS
    rounds_mod.CHUNK_ELEMENTS = 1000 * cfg.L
    try:
        chunked = mwm_rounds(stream.to(cuda), cfg)
    finally:
        rounds_mod.CHUNK_ELEMENTS = old
    assert torch.equal(chunked.assigned.cpu(), want.assigned)


def test_rounds_at_the_papers_size_on_card(cuda):
    """``mwm_rounds`` on the paper's graph as the benchmark draws it
    (kron48-L64 at 2^20 vertices, ~44 M edges) in its generated order:
    it reaches its fixed point with a peak under 40 GB, and its bits are
    the per-edge engine's."""
    from perfbench.gen import rmat
    from repro_torch import obs
    from repro_torch.core import mwm_rounds

    config = _bench_config("kron48-L64")
    src, dst, w = rmat.generate(config, 20, torch.Generator(device=cuda).manual_seed(1))
    stream = EdgeStream(src, dst, w, torch.ones(src.shape, dtype=torch.bool, device=src.device))
    cfg = SubstreamConfig(n=1 << 20, L=config["L"], eps=config["eps"])
    tel = obs.Telemetry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = mwm_rounds(stream, cfg, packed=True, telemetry=tel)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() <= 40e9
    assert tel.match_calls[-1].counters["rounds.converged"]
    want = substream_match(stream, cfg)
    assert torch.equal(got.assigned, want.assigned) and torch.equal(got.mb_packed, want.mb_packed)


@pytest.mark.parametrize("dtype, reduce", [(torch.int32, "amin"), (torch.float32, "amax"),
                                           (torch.int32, "amax")])
def test_scatter_reductions_on_card(cuda, dtype, reduce):
    """The CUDA build's ``scatter_reduce_`` for the types and reductions the
    rounds (int32 amin) and ``segment_max`` (float32, int32 amax) use, on
    an expanded index, equal to the CPU; and ``index_add_`` in float32
    within 1e-5."""
    g = torch.Generator().manual_seed(3)
    n, m, L = 1000, 50_000, 64
    idx = torch.randint(0, n, (m,), generator=g)
    if dtype == torch.float32:
        src = torch.randn((m, L), generator=g)
        init = torch.full((n, L), float("-inf"))
    else:
        src = torch.randint(0, 1 << 30, (m, L), generator=g).to(dtype)
        init = torch.full((n, L), torch.iinfo(dtype).max if reduce == "amin" else 0, dtype=dtype)
    want = init.clone().scatter_reduce_(0, idx[:, None].expand(-1, L), src, reduce)
    got = init.to(cuda).scatter_reduce_(0, idx.to(cuda)[:, None].expand(-1, L), src.to(cuda), reduce)
    assert torch.equal(got.cpu(), want)
    if dtype == torch.float32:
        s = torch.zeros((n, L)).index_add_(0, idx, src)
        s_card = torch.zeros((n, L), device=cuda).index_add_(0, idx.to(cuda), src.to(cuda))
        torch.testing.assert_close(s_card.cpu(), s, rtol=1e-5, atol=1e-5)


def test_segment_ops_on_card_match_cpu(cuda):
    """Card against CPU: the maximum exactly; sums and means within 1e-5 of
    the sum of their terms' magnitudes (atomics reorder the float32 sums,
    and a segment's sum may cancel to near 0); softmax within rtol 1e-5."""
    from repro_torch import graph

    src, dst = graph.kronecker_graph(12, edge_factor=8, seed=2)
    n = 1 << 12
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    scores = torch.from_numpy(rng.normal(size=src.shape[0]).astype(np.float32))
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    for reduce in ("sum", "mean", "max"):
        want = graph.scatter_messages(feats, s, d, n, reduce=reduce)
        got = graph.scatter_messages(feats.to(cuda), s.to(cuda), d.to(cuda), n, reduce=reduce).cpu()
        if reduce == "max":
            assert torch.equal(got, want)
            continue
        size = graph.scatter_messages(feats.abs(), s, d, n, reduce=reduce)
        assert ((got - want).abs() <= 1e-5 * size).all()
    torch.testing.assert_close(graph.segment_softmax(scores.to(cuda), d.to(cuda), n).cpu(),
                               graph.segment_softmax(scores, d, n), rtol=1e-5, atol=0)
    assert torch.equal(graph.degrees(s.to(cuda), d.to(cuda), n).cpu(), graph.degrees(s, d, n))


def test_coarsen_gseq_and_matchings_on_card_match_cpu(cuda):
    """``coarsen_by_matching`` runs Part 1 once, on the rounds engine, and
    equals the CPU run; ``gseq`` and ``substream_matchings`` on the card
    equal the CPU."""
    from repro_torch import graph
    from repro_torch.core import gseq, substream_matchings

    src, dst = graph.kronecker_graph(10, edge_factor=4, seed=4)
    w = graph.uniform_weights(src.shape[0], 32, 0.1, seed=4)
    before = dict(build.launches)
    got = graph.coarsen_by_matching(src, dst, w, 1 << 10)
    assert _launched(before) == {kernel.ROUNDS_NAME: 1, kernel.ROUNDS_KEYS_NAME: 1}
    for a, b in zip(got, graph.coarsen_by_matching(src, dst, w, 1 << 10, device="cpu")):
        np.testing.assert_array_equal(a, b)
    c = rmat_case(9, edge_factor=4, L=16, pad=3)
    stream, cfg = _on(c, "cpu")
    np.testing.assert_array_equal(gseq(stream.to(cuda), cfg.n), gseq(stream, cfg.n, device="cpu"))
    assert torch.equal(substream_matchings(stream.to(cuda), cfg).cpu(),
                       substream_matchings(stream, cfg, device="cpu"))


def test_sampled_gin_trainer_on_card(cuda):
    """The sampled GIN trainer on a Kronecker graph (scale 10): its
    coarsening is one Part-1 call on the rounds engine (one keys and one
    rounds launch a slice, nothing else); step 1's loss and gradients are
    the CPU's on the same batch; its steps launch no kernel."""
    from repro_torch import graph
    from repro_torch.launch.gnn_train import SampledGINTrainer
    from repro_torch.testing.gnn_check import cpu_loss_and_grads, grad_errors

    src, dst = graph.kronecker_graph(10, edge_factor=8, seed=5)
    w = graph.uniform_weights(src.shape[0], 16, 0.1, seed=5)
    before = dict(build.launches)
    trainer = SampledGINTrainer(src, dst, w, 1 << 10, device=cuda)
    launched = _launched(before)
    slices = launched.get(kernel.ROUNDS_NAME, 0)
    assert slices >= 1 and launched == {kernel.ROUNDS_NAME: slices,
                                        kernel.ROUNDS_KEYS_NAME: slices}
    before = dict(build.launches)
    batch, _, _ = trainer.next_batch()
    loss_cpu, grads_cpu = cpu_loss_and_grads(trainer.model, batch)
    np.testing.assert_allclose(float(trainer.step(batch)["loss"]), loss_cpu, rtol=1e-4)
    errs = grad_errors(trainer.model, grads_cpu)
    assert max(errs.values()) <= 1e-3, errs
    batch, _, _ = trainer.next_batch()
    assert np.isfinite(float(trainer.step(batch)["loss"]))
    assert _launched(before) == {}


@pytest.mark.parametrize("example", ["quickstart", "matching_e2e"])
def test_matching_examples_on_card(cuda, tmp_path, example):
    """Each matching example at its defaults on the card: its Part 1 runs on
    the rounds engine (at least one launch), and its matching's weight is
    within 4 + eps of the exact maximum."""
    from repro_torch.launch import matching_e2e, quickstart

    before = dict(build.launches)
    out = (quickstart.run() if example == "quickstart"
           else matching_e2e.run(ckpt_dir=str(tmp_path / "ckpt")))
    assert _launched(before).get(kernel.ROUNDS_NAME, 0) >= 1
    assert out["ratio"] <= out["bound"] + 1e-6, out


def test_sharded_rounds_on_a_one_card_nccl_mesh(cuda, tmp_path):
    """A 1x1 NCCL mesh (world size 1, a file store) equals ``mwm_rounds``."""
    import torch.distributed as dist

    from repro_torch.core import mwm_rounds, mwm_rounds_sharded
    from repro_torch.distributed import RemeshPlan, build_mesh

    c = rmat_case(10, edge_factor=8, L=64, pad=5)
    stream, cfg = _on(c, cuda)
    want = mwm_rounds(stream, cfg)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = build_mesh(RemeshPlan(data=1, model=1, pod=0, dropped_devices=0))
        got = mwm_rounds_sharded(stream, cfg, mesh)
    finally:
        dist.destroy_process_group()
    assert got.assigned.device.type == "cuda"
    assert torch.equal(got.assigned, want.assigned) and torch.equal(got.mb, want.mb)


@pytest.mark.parametrize("arch_id", ["gin-tu", "egnn", "meshgraphnet", "equiformer-v2"])
def test_gnn_train_step_on_card_matches_cpu(cuda, arch_id):
    """One train step of each GNN at its smoke config on the card (no
    kernel of the port launched), held to the port on the CPU from the same
    weights: the loss within rtol 1e-4,
    each gradient's largest error at most 1e-3 of its largest magnitude
    (atomics reorder the float32 segment sums), or 1e-6 where that
    magnitude is under 1e-3 (``grad_errors``' floor: a gradient that is
    zero in exact arithmetic is rounding noise on both). TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` at its default, False): its
    10-bit mantissa would show as exactly this kind of error."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_gnn_batch
    from repro_torch.launch.steps import _gnn_module, train_step
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.testing.gnn_check import cpu_loss_and_grads, grad_errors

    assert not torch.backends.cuda.matmul.allow_tf32
    arch = get_arch(arch_id)
    cfg = arch.smoke_config
    batch = make_gnn_batch(48, 160, cfg.d_in, n_classes=getattr(cfg, "n_classes", 0)
                           if arch_id == "gin-tu" else 0, d_out=getattr(cfg, "d_out", 1),
                           coords=True, seed=1, device=cuda)
    model = _gnn_module(arch).MODEL(cfg, device=cuda)
    loss_cpu, grads_cpu = cpu_loss_and_grads(model, batch)
    before = dict(build.launches)
    out = train_step(model, AdamW(model.parameters(), AdamWConfig(lr=1e-3)), batch)
    assert out["loss"].device.type == "cuda"
    np.testing.assert_allclose(float(out["loss"]), loss_cpu, rtol=1e-4)
    errs = grad_errors(model, grads_cpu)
    assert max(errs.values()) <= 1e-3, errs
    assert _launched(before) == {}  # message passing is plain PyTorch


LM_IDS = ["internlm2-20b", "minicpm-2b", "gemma-7b", "moonshot-v1-16b-a3b", "grok-1-314b"]


def _rel_err(got, want) -> float:
    """Largest error over the largest magnitude of ``want`` (on the CPU)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_serving_on_card_matches_cpu(cuda, arch_id):
    """Each LM at its smoke config in float32, built on the CPU from seed 0
    and copied to the card: ``prefill`` into a longer cache and three greedy
    ``decode_step``s (committed in place), on both; every logit and cache
    entry within 1e-4 of the CPU's largest magnitude (TF32 off); no kernel
    of the port launched (attention and MoE dispatch are plain PyTorch)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_arch(arch_id).smoke_config, param_dtype=torch.float32)
    host = tfm.Transformer(cfg, device="cpu", seed=0)
    card = copy.deepcopy(host).to(cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    out = {}
    before = dict(build.launches)
    for name, model in (("cpu", host), ("cuda", card)):
        dev = next(model.parameters()).device
        cache, last = tfm.prefill(model, tokens.to(dev), max_len=44)
        token, logits = tokens[:, -1].to(dev), []
        for t in range(3):
            lg, (k, v) = tfm.decode_step(model, cache, token, 40 + t)
            cache["k"][:, :, 40 + t] = k[:, :, 0]
            cache["v"][:, :, 40 + t] = v[:, :, 0]
            logits.append(lg)
            token = lg.argmax(-1)
        out[name] = (last, torch.stack(logits), cache)
    assert out["cuda"][1].device.type == "cuda"
    assert _rel_err(out["cuda"][0], out["cpu"][0]) <= 1e-4
    assert _rel_err(out["cuda"][1], out["cpu"][1]) <= 1e-4
    for k in ("k", "v"):
        assert _rel_err(out["cuda"][2][k], out["cpu"][2][k]) <= 1e-4
    assert _launched(before) == {}


def test_decode_step_equals_backbone_on_card(cuda):
    """gemma-7b at its smoke config (bfloat16 weights, a float32 stream) on
    the card: prefill of 40 tokens and one decode step give the logits of
    ``backbone`` over the 41 tokens, whose last attention chunk is short
    (chunks of 32), within 3e-2 of the largest logit."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = get_arch("gemma-7b").smoke_config
    assert 41 % cfg.attn_chunk
    model = tfm.Transformer(cfg, device=cuda, seed=0)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 41)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        cache, _ = tfm.prefill(model, tokens[:, :40], max_len=41)
        logits, _ = tfm.decode_step(model, cache, tokens[:, 40], 40)
        want = tfm.lm_logits(model, tfm.backbone(model, tokens)[:, 40])
    assert _rel_err(logits, want) <= 3e-2


@pytest.mark.parametrize("kind", ["serve_scores", "retrieval", "serve_chunks"])
def test_bert4rec_serving_on_card_matches_cpu(cuda, kind, monkeypatch):
    """BERT4Rec at its smoke config (4,096 items), one serving or retrieval
    step on the card against the CPU (``serve_chunks``: 8,192 users, scored
    in two chunks of 4,096 and put back together row for row): the top-100
    values within 1e-5 of the largest, and no kernel of the port launched."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch, registry
    from repro_torch.data import RecsysPipeline
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec as b4r

    arch = get_arch("bert4rec")
    arch = dataclasses.replace(arch, config=dataclasses.replace(arch.smoke_config, item_vocab=4096))
    cfg = arch.config
    shape = {"serve_scores": registry.ShapeSpec("s", "serve_scores", batch=8),
             "serve_chunks": registry.ShapeSpec("c", "serve_scores", batch=2 * 4096),
             "retrieval": registry.ShapeSpec("r", "retrieval", batch=1, n_candidates=4096)}[kind]
    host = b4r.Bert4Rec(cfg, device="cpu", seed=0)
    card = copy.deepcopy(host).to(cuda)
    batch = RecsysPipeline(cfg.item_vocab, shape.batch, cfg.seq_len, cfg.n_mask, cfg.n_negatives,
                           cfg.n_context, seed=1, device="cpu").batch_at(0)
    batch["candidates"] = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.item_vocab, 4096).astype(np.int32))
    want = steps.make_recsys_step(arch, shape, device="cpu")(host, batch)
    chunks, row_chunks = [], steps.row_chunks

    def counted(t, n):
        chunks.append(n)
        return row_chunks(t, n)

    monkeypatch.setattr(steps, "row_chunks", counted)
    before = dict(build.launches)
    got = steps.make_recsys_step(arch, shape, device=cuda)(card, batch)
    assert got[0].device.type == "cuda" and got[0].shape == want[0].shape
    assert _rel_err(got[0], want[0]) <= 1e-5
    assert _launched(before) == {}
    if kind == "serve_chunks":  # the users and their context, each in two chunks
        assert chunks == [2, 2] and got[0].shape[0] == shape.batch


@pytest.mark.parametrize("which", ["transformer", "bert4rec"])
def test_card_build_equals_cpu_build(cuda, which):
    """From one seed, the default (CPU) generator gives the card the CPU's
    values; a CUDA generator draws on the card, with the same distributions."""
    from repro_torch.configs import get_arch
    from repro_torch.models import bert4rec as b4r
    from repro_torch.models import transformer as tfm

    cls, arch_id = ((tfm.Transformer, "gemma-7b") if which == "transformer"
                    else (b4r.Bert4Rec, "bert4rec"))
    cfg = get_arch(arch_id).smoke_config
    host, card = cls(cfg, device="cpu", seed=3), cls(cfg, device=cuda, seed=3)
    for (name, a), (_, b) in zip(host.state_dict().items(), card.state_dict().items()):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu()), name
    drawn = cls(cfg, device=cuda, generator=torch.Generator("cuda").manual_seed(3))
    again = cls(cfg, device=cuda, generator=torch.Generator("cuda").manual_seed(3))
    for name, p in drawn.named_parameters():
        assert torch.equal(p, again.get_parameter(name)), name
    big = max(drawn.named_parameters(), key=lambda kv: kv[1].numel())
    ref = host.get_parameter(big[0]).float()
    assert not torch.equal(big[1].cpu(), host.get_parameter(big[0]))
    assert abs(float(big[1].detach().float().std()) - float(ref.std())) <= 0.05 * float(ref.std())


@pytest.mark.parametrize("layout", ["contiguous", "decode"])
def test_matmul_f32_of_bfloat16_on_card(cuda, layout):
    """bfloat16 operands, float32 result on the card (cuBLAS, float32
    accumulation) against the float64 product of the same values, within
    the float32 summation bound: dense
    batches, and the decode step's views (a slice of the probabilities, the
    cache's values read in place, [Kv, S, D] at strides (D, Kv * D, 1))."""
    from repro_torch.models.transformer import _matmul_f32

    g = torch.Generator().manual_seed(0)
    if layout == "contiguous":
        a = torch.randn(15, 64, 256, generator=g).to(torch.bfloat16).to(cuda)
        b = torch.randn(15, 256, 96, generator=g).to(torch.bfloat16).to(cuda)
    else:
        S = 1000
        a = torch.rand(4, 2, S + 1, generator=g).to(torch.bfloat16).to(cuda)[..., :S]
        b = torch.randn(S, 4, 64, generator=g).to(torch.bfloat16).to(cuda).permute(1, 0, 2)
    got = _matmul_f32(a, b)
    want = torch.matmul(a.double(), b.double())
    assert got.dtype == torch.float32
    # float32 sums of K exact products: within K * 2^-24 of the largest (a
    # layout fault would be off by O(1))
    K = a.shape[-1]
    assert _rel_err(got, want) <= K * 2.0**-24, (_rel_err(got, want), K)


def _train_on_both(model_cpu, step_for, batch, lr, card_device):
    """One train step of ``model_cpu`` and of its copy on the card (their own
    AdamW at ``lr``): {"cpu" / "cuda": (output, model)}."""
    import copy

    from repro_torch.optim import AdamW, AdamWConfig

    out = {}
    card = copy.deepcopy(model_cpu).to(card_device)
    for name, model in (("cpu", model_cpu), ("cuda", card)):
        dev = next(model.parameters()).device
        opt = AdamW(model.parameters(), AdamWConfig(lr=lr))
        out[name] = (step_for(dev)(model, opt, batch), model)
    return out


def _assert_train_held(out, lr, loss_rtol=1e-4, grad_rel=1e-3):
    """Loss within ``loss_rtol``; each gradient within ``grad_rel`` of
    max(its largest magnitude, 1e-3) (``grad_errors``); each parameter after
    the step within 2 * lr of the CPU's (the first update is about lr *
    sign(g): a gradient that is rounding noise may take the other sign)."""
    from repro_torch.testing.gnn_check import grad_errors

    (got, card), (want, host) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=10 * loss_rtol)
    grads = {n: p.grad.detach().cpu() for n, p in host.named_parameters()}
    errs = grad_errors(card, grads)
    assert max(errs.values()) <= grad_rel, errs
    for (name, a), (_, b) in zip(card.named_parameters(), host.named_parameters()):
        b = b.detach().float()
        diff = (a.detach().float().cpu() - b).abs()
        # and one rounding of the parameter's dtype (an ulp of bf16 at |p|)
        bound = 2 * lr * (1 + 1e-3) + 1e-6 + torch.finfo(a.dtype).eps * b.abs()
        assert (diff <= bound).all(), (name, float(diff.max()))


@pytest.mark.parametrize("arch_id", LM_IDS + ["minicpm-2b-bf16"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch_id):
    """One ``make_lm_train_step`` step of each LM at its smoke config, float32
    (bfloat16 for ``minicpm-2b-bf16``: the card's bf16 GEMM with float32
    output and its backward, against the CPU's float32 products of the same
    bf16 values, held at bf16's 5e-2), from the same weights, with two
    router columns tied in the MoE archs (the routing ties break alike); no
    kernel of the port launched."""
    import dataclasses

    from repro_torch.configs import get_arch, registry
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    assert not torch.backends.cuda.matmul.allow_tf32
    bf16 = arch_id.endswith("-bf16")
    arch = get_arch(arch_id.removesuffix("-bf16"))
    cfg = dataclasses.replace(arch.smoke_config,
                              param_dtype=torch.bfloat16 if bf16 else torch.float32)
    arch = dataclasses.replace(arch, config=cfg)
    shape = registry.ShapeSpec("small", "train", seq_len=64, global_batch=2)
    host = tfm.Transformer(cfg, device="cpu", seed=0)
    if cfg.is_moe:
        with torch.no_grad():
            host.layers.router[..., 1] = host.layers.router[..., 0]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)).astype(np.int32))
    lr = 1e-3
    before = dict(build.launches)
    out = _train_on_both(host, lambda dev: steps.make_lm_train_step(
        arch, shape, steps.AdamWConfig(lr=lr), device=dev), {"tokens": tokens}, lr, cuda)
    assert out["cuda"][0]["loss"].device.type == cuda.type
    assert _launched(before) == {}
    if bf16:
        _assert_train_held(out, lr, loss_rtol=1e-2, grad_rel=5e-2)
    else:
        _assert_train_held(out, lr)


def test_bert4rec_train_step_on_card_matches_cpu(cuda):
    """One ``make_recsys_step`` train step of BERT4Rec at its smoke config on
    the card against the CPU, from the same weights; no kernel of the port
    launched."""
    import dataclasses

    from repro_torch.configs import get_arch, registry
    from repro_torch.data import RecsysPipeline
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec as b4r

    arch = get_arch("bert4rec")
    cfg = arch.smoke_config
    arch = dataclasses.replace(arch, config=cfg)
    shape = registry.ShapeSpec("small", "train", batch=8)
    host = b4r.Bert4Rec(cfg, device="cpu", seed=0)
    batch = RecsysPipeline(cfg.item_vocab, 8, cfg.seq_len, cfg.n_mask, cfg.n_negatives,
                           cfg.n_context, seed=1, device="cpu").batch_at(0)
    lr = 1e-3
    before = dict(build.launches)
    out = _train_on_both(host, lambda dev: steps.make_recsys_step(
        arch, shape, steps.AdamWConfig(lr=lr), device=dev), batch, lr, cuda)
    assert out["cuda"][0]["loss"].device.type == cuda.type
    assert _launched(before) == {}
    _assert_train_held(out, lr)


#: the rules of the JAX package's multi-device test, as a 1x1 mesh places them
MESH_RULES = {"dp": ("data",), "embed": None, "heads": "model", "kv_heads": "model",
              "mlp": "model", "vocab": "model", "layers": None, "model_seq": None}
#: the one-card mesh's LM step and its dry-run cells (arch, shape, multi_pod):
#: one production cell per family on a fake world of 256 ranks and one of 512
MESH_LR, MESH_STEPS = 1e-3, 5
DRYRUN_CELLS = (("gemma-7b", "train_4k", False), ("gin-tu", "ogb_products", False),
                ("bert4rec", "serve_p99", False), ("minicpm-2b", "train_4k", True))


def _mesh_lm():
    """gemma-7b at its published width cut to 2 of its 28 layers, float32,
    and a train shape of 4 x 1,024 tokens: a step whose peak is the model's
    (~21 GB of weights, gradients and moments), not the allocator's."""
    import dataclasses

    from repro_torch.configs import get_arch, registry

    arch = get_arch("gemma-7b")
    cfg = dataclasses.replace(arch.config, n_layers=2, param_dtype=torch.float32)
    return (dataclasses.replace(arch, config=cfg),
            registry.ShapeSpec("mesh", "train", seq_len=1024, global_batch=4))


def _lm_steps(mesh):
    """MESH_STEPS ``make_lm_train_step`` steps of :func:`_mesh_lm` drawn on
    the card from seed 0, on the same batch each step, under MESH_RULES:
    with ``mesh``, every parameter a DTensor on it; with None, the plain
    model. The losses, the peak and the median ms a step (CUDA events)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch.steps import make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import distribute_params
    from repro_torch.optim import AdamW, AdamWConfig

    arch, shape = _mesh_lm()
    tokens = TokenPipeline(arch.config.vocab, shape.global_batch, shape.seq_len, seed=0).batch_at(0)
    torch.cuda.empty_cache()
    model = tfm.Transformer(arch.config, generator=torch.Generator("cuda").manual_seed(0))
    if mesh is not None:
        distribute_params(model, tfm.param_specs(arch.config), MESH_RULES, mesh)
    opt_cfg = AdamWConfig(lr=MESH_LR)
    opt = AdamW(model.parameters(), opt_cfg)
    step = make_lm_train_step(arch, shape, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    with sharding_rules(MESH_RULES), use_mesh(mesh):
        for _ in range(MESH_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(float(step(model, opt, {"tokens": tokens})["loss"]))
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    del model, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "peak_bytes": peak, "step_ms": float(np.median(ms[1:]))}


def _lm_on_a_one_card_mesh(store):
    """:func:`_lm_steps` on a 1x1 NCCL mesh (world size 1, a file store at
    ``store``), then without a mesh; and the kernel launches of both."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    before = dict(build.launches)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        sharded = _lm_steps(make_host_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    return {"sharded": sharded, "plain": _lm_steps(None), "launches": _launched(before)}


def _dryrun_on_the_mesh_step(measured):
    """The dry-run's model of :func:`_mesh_lm`'s step on a 1x1 fake world
    held to ``measured`` (peak bytes, ms a step) and to ``FlopCounterMode``
    over one step on the card, then DRYRUN_CELLS on fake worlds (``meta``
    tensors): the calibration without its record, and each cell's error
    and peak. Runs in a process that never held an NCCL group."""
    from repro_torch.launch.dryrun import calibrate, run_cell
    from repro_torch.optim import AdamWConfig

    arch, shape = _mesh_lm()
    cal = calibrate(arch, shape, MESH_RULES, measured, AdamWConfig(lr=MESH_LR))
    cells = []
    for cell in DRYRUN_CELLS:
        rec = run_cell(*cell)
        cells.append({"cell": list(cell), "error": rec.get("error"),
                      "peak_per_device": rec.get("memory", {}).get("peak_per_device", 0)})
    return {"calibration": {k: v for k, v in cal.items() if k != "record"}, "cells": cells}


@pytest.fixture(scope="module")
def lm_on_a_one_card_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return _in_child("_lm_on_a_one_card_mesh", 600,
                     str(tmp_path_factory.mktemp("mesh") / "store"))


def test_lm_train_step_on_a_one_card_nccl_mesh(cuda, lm_on_a_one_card_mesh):
    """``make_lm_train_step`` with every parameter a DTensor on a 1x1 NCCL
    mesh gives the losses of the same steps without a mesh (within 1e-5),
    and they fall; no kernel of the port launched. A world larger than 1
    needs a card per rank: the multi-rank checks are the gloo tests."""
    got = np.array(lm_on_a_one_card_mesh["sharded"]["losses"])
    want = np.array(lm_on_a_one_card_mesh["plain"]["losses"])
    assert np.isfinite(got).all() and got[-1] < got[0] and want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert lm_on_a_one_card_mesh["launches"] == {}


def test_dryrun_holds_to_the_step_on_a_one_card_mesh(cuda, lm_on_a_one_card_mesh):
    """The dry-run's model of that step: its peak within 0.8-1.25x of the
    measured peak, its step-time lower bound at most the measured step, its
    FLOPs within 1 % of ``FlopCounterMode``'s; one production cell per
    family on 256 and 512 fake ranks records a peak and no error. In a
    process of its own, killed after 300 s."""
    from repro_torch.launch.dryrun import FLOPS_RTOL, PEAK_BAND

    run = lm_on_a_one_card_mesh["sharded"]
    out = _in_child("_dryrun_on_the_mesh_step", 300,
                    {"peak_bytes": run["peak_bytes"], "step_ms": run["step_ms"]})
    cal = out["calibration"]
    assert (PEAK_BAND, FLOPS_RTOL) == ((0.8, 1.25), 0.01)
    assert PEAK_BAND[0] <= cal["peak_ratio"] <= PEAK_BAND[1], cal
    assert cal["lower_bound_s"] <= run["step_ms"] / 1e3, cal
    assert cal["flops_rel_err"] <= FLOPS_RTOL and cal["ok"], cal
    assert [c["cell"] for c in out["cells"]] == [list(c) for c in DRYRUN_CELLS]
    assert all(c["error"] is None and c["peak_per_device"] > 0 for c in out["cells"]), out["cells"]


@pytest.mark.parametrize("k,shards", [(10, 4), (100, 16)])
def test_sharded_topk_ties_on_card(cuda, k, shards):
    """Scores from three levels (ties straddle the k-th place in every slice):
    the card's values and indices equal the CPU's (which the CPU tests hold
    to ``jax.lax.top_k``)."""
    from repro_torch.launch.steps import sharded_topk

    scores = torch.from_numpy(np.random.default_rng(k).integers(0, 3, (64, 65536)).astype(np.float32))
    want = sharded_topk(scores, k, shards)
    got = sharded_topk(scores.to(cuda), k, shards)
    assert got[1].device.type == cuda.type
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_moe_router_ties_on_card(cuda):
    """``_moe_ffn`` with three tied router columns (E 8, top 3, 2 groups,
    capacity 1.0: pairs dropped) on the card against the CPU: the same
    choices, so the outputs agree to float32 rounding."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke_config, n_experts=8,
                              top_k=3, moe_groups=2, capacity_factor=1.0,
                              param_dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(128, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, 8, generator=g)
    router[:, 1] = router[:, 0]
    router[:, 2] = router[:, 0]
    w1 = torch.randn(8, cfg.d_model, 2 * cfg.d_ff, generator=g) * 0.1
    w2 = torch.randn(8, cfg.d_ff, cfg.d_model, generator=g) * 0.1
    want = tfm._moe_ffn(x, router, w1, w2, cfg)
    got = tfm._moe_ffn(*(t.to(cuda) for t in (x, router, w1, w2)), cfg)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_adamw_is_bit_equal_on_card(cuda, monkeypatch, dtype):
    """``AdamW.step`` walking slices of 7 elements against one pass over each
    leaf (the step before slicing), on the card: parameters, moments and the
    norm bit-equal over three steps, clipping active."""
    from repro_torch.optim import AdamW, AdamWConfig, adamw

    monkeypatch.setattr(adamw, "SLICE_ELEMS", 7)
    cfg = AdamWConfig(lr=1e-2, grad_clip=0.5)
    g = torch.Generator(device=cuda).manual_seed(3)
    shapes = [(5, 4, 3), (9, 2), (13,), (40, 8)]
    ours = [torch.nn.Parameter(torch.randn(s, generator=g, device=cuda).to(dtype)) for s in shapes]
    opt = AdamW(ours, cfg)
    ref = [p.detach().clone() for p in ours]
    m = [torch.zeros(s, device=cuda) for s in shapes]
    v = [torch.zeros(s, device=cuda) for s in shapes]
    for step in range(1, 4):
        grads = [(torch.randn(s, generator=g, device=cuda) * 3).to(dtype) for s in shapes]
        for p, gr in zip(ours, grads):
            p.grad = gr.clone()
        norm = opt.step()
        sq = sum(torch.sum(torch.square(gr.float())) for gr in grads)
        want = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(want, min=1e-9), max=1.0)
        count = torch.tensor(float(step), device=cuda)
        b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=cuda), count)
        b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=cuda), count)
        for i, gr in enumerate(grads):
            g32, p32 = (gr * scale).to(dtype).float(), ref[i].float()
            m[i] = cfg.b1 * m[i] + (1 - cfg.b1) * g32
            v[i] = cfg.b2 * v[i] + (1 - cfg.b2) * g32 * g32
            upd = (m[i] / b1c) / (torch.sqrt(v[i] / b2c) + cfg.eps)
            ref[i] = (p32 - cfg.lr * (upd + cfg.weight_decay * p32)).to(dtype)
        assert torch.equal(norm, want)
        for i, p in enumerate(ours):
            assert torch.equal(p.detach(), ref[i]) and torch.equal(p.grad, grads[i])
            assert torch.equal(opt.state[p]["m"], m[i]) and torch.equal(opt.state[p]["v"], v[i])
