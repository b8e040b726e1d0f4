"""Card-only tests of the port: the CUDA kernels (packed and unpacked
layouts) against their plain versions, with and without carried bits, the
per-edge kernels on streams aimed at their batch window too, the four
wave kernels on streams aimed at their slot ring (against the packed
per-edge kernel as well), and the main path and the epoch executor on the
card against the same calls on the CPU; then the robustness and
observability layers on the card: the per-edge kernels at L = 1 (the
device merge's shape), ``merge_device``, every rung of the fallback
ladder, the telemetry records of the three entries, ``validate``, and
snapshots with the execution guard around the epoch executor. They skip
without a CUDA device; on a machine with an NVIDIA card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline
from repro_torch.core.bitpack import unpack_bits
from repro_torch.graph import waves
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
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
    c = CASES["rmat10_L64"]()
    got = match_epochs(*_on(c, cuda), epochs=3, engine=engine, packed=packed)
    want = match_epochs(*_on(c, "cpu"), epochs=3, engine="scan", packed=packed, device="cpu")
    assert got.is_packed == packed
    assert torch.equal(got.assigned.cpu(), want.assigned)
    assert torch.equal(got.mb.cpu(), want.mb)


@pytest.mark.parametrize("kw", [{}, {"schedule": "waves"}, {"schedule": "mega"},
                                {"packed": False}, {"schedule": "waves", "packed": False},
                                {"schedule": "mega", "packed": False}])
@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "rmat10_L64"])
def test_pipeline_on_card_matches_cpu(cuda, case, kw):
    c = CASES[case]()
    idx, weight = mwm_pipeline(*_on(c, cuda), part1="kernel", **kw)
    want_idx, want_weight = mwm_pipeline(*_on(c, "cpu"), part1="kernel", device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_weight


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
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_clean_ladder_on_card(cuda, schedule, packed):
    from repro_torch import obs

    c = CASES["rmat10_L64"]()
    _, _, want = _part1_on_cpu(c)
    tel = obs.Telemetry()
    name = (kernel.NAME if packed else kernel.UNPACKED_NAME) if schedule == "edges" \
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
    assert rec.roofline()["achieved_fraction"] > 0


@pytest.mark.parametrize("policy", ["strict", "sanitize"])
def test_validate_on_card_matches_cpu(cuda, policy):
    from repro_torch.core import StreamValidationError, validate_stream
    from repro_torch.testing import faultline

    c = CASES["rmat10_L64"]()
    cpu_stream, cfg = _on(c, "cpu")
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
    """``coarsen_by_matching`` launches the packed per-edge kernel once and
    equals the CPU run; ``gseq`` and ``substream_matchings`` on the card
    equal the CPU."""
    from repro_torch import graph
    from repro_torch.core import gseq, substream_matchings

    src, dst = graph.kronecker_graph(10, edge_factor=4, seed=4)
    w = graph.uniform_weights(src.shape[0], 32, 0.1, seed=4)
    before = build.launches[kernel.NAME]
    got = graph.coarsen_by_matching(src, dst, w, 1 << 10)
    assert build.launches[kernel.NAME] == before + 1
    for a, b in zip(got, graph.coarsen_by_matching(src, dst, w, 1 << 10, device="cpu")):
        np.testing.assert_array_equal(a, b)
    c = rmat_case(9, edge_factor=4, L=16, pad=3)
    stream, cfg = _on(c, "cpu")
    np.testing.assert_array_equal(gseq(stream.to(cuda), cfg.n), gseq(stream, cfg.n, device="cpu"))
    assert torch.equal(substream_matchings(stream.to(cuda), cfg).cpu(),
                       substream_matchings(stream, cfg, device="cpu"))


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
