"""The CUDA kernels for Part 1, and their plain versions.

Each wrapper replaces a TPU kernel of the JAX package
(``repro/kernels/substream_match/kernel.py``), in one of its two layouts
of the bit block: packed uint8 bit planes (bit ``j`` of word ``k`` =
substream ``8k + j``) or unpacked int8 (byte ``l`` = substream ``l``, set
when non-zero).

* :func:`substream_match_packed`, the per-edge processor ``_kernel_packed``
  (``:117``), and :func:`substream_match_unpacked`, the per-edge processor
  ``_kernel`` (``:74``), launch ``csrc/substream_match_edges.cu``;
  :func:`substream_match_rounds` computes ``_kernel_packed``'s function
  for rows of one 64-bit word on the whole card (chunked bit-parallel
  rounds) and launches the same library;
* :func:`substream_match_mega`, the tile megakernel
  ``_kernel_waves_mega_packed`` (``:519``), and :func:`substream_match_waves`,
  the segment kernel ``_kernel_waves_packed`` (``:243``), and with
  ``packed=False`` ``_kernel_waves_mega`` (``:451``) and ``_kernel_waves``
  (``:168``), launch the four entries of ``csrc/substream_match_waves.cu``,
  one walk for all four.

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
its ``*_plain`` version, the same function in plain PyTorch. There is no
fallback between the two.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.core.matching import highest_lane
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import ref

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: the two per-edge kernels share one source (and one library)
NAME = "substream_match_packed"
UNPACKED_NAME = "substream_match_unpacked"
EDGES_LIBRARY = "substream_match_edges"
EDGES_SOURCE = _CSRC / "substream_match_edges.cu"
#: The per-edge kernels' schedule, compile-time constants of ``EDGES_SOURCE``:
#: a walker warp runs the stream in batches of ``EDGE_BATCH`` edges (one per
#: lane), loads the bit-block rows ``EDGE_PREFETCH`` batch ahead and forwards
#: the post-values of the window (the previous batch and the earlier lanes),
#: while six helper warps prepare the next batch; each CTA owns
#: ``EDGE_CHUNK_BITS`` substreams (one 64-bit word per vertex); the stream is
#: staged in shared memory ``EDGE_STAGE_EDGES`` edges at a time.
EDGE_BATCH = 32
EDGE_PREFETCH = 1
EDGE_CHUNK_BITS = 64
EDGE_STAGE_EDGES = 1024
#: The rounds engine of the same source (and library): the stream in chunks
#: of at most ``EDGE_ROUNDS_CHUNK`` edges, each grouped by vertex and matched
#: in bit-parallel rounds by at most ``EDGE_ROUNDS_BLOCKS`` resident CTAs of
#: ``EDGE_ROUNDS_THREADS`` threads, ``EDGE_ROUNDS_ITEMS`` incidences a thread
#: (a card that holds fewer CTAs gets shorter chunks, :func:`rounds_blocks`).
#: Its two launches are counted apart: the grouping keys and the rounds.
ROUNDS_NAME = "substream_match_rounds"
ROUNDS_KEYS_NAME = "substream_match_rounds_keys"
EDGE_ROUNDS_THREADS = 512
EDGE_ROUNDS_ITEMS = 4
EDGE_ROUNDS_BLOCKS = 128
EDGE_ROUNDS_CHUNK = 131072
#: widest row it takes, in uint8 words: one 64-bit word (L <= 64)
ROUNDS_MAX_WIDTH = 8
#: int64 words of its scratch: the B_v word of each edge of a chunk, four
#: words of look-back state per CTA, four counters
ROUNDS_SCRATCH_WORDS = EDGE_ROUNDS_CHUNK + 4 * EDGE_ROUNDS_BLOCKS + 4
#: Device bytes an edge of a slice takes while the slice is grouped: its two
#: int32 keys (8 B) and what ``torch.sort`` takes beyond them, 32.2 B a key
#: on the card (the sorted keys, the int64 indices, the int64 identity it
#: sorts with them, the radix sort's alternate buffers).
ROUNDS_GROUP_BYTES = 73
#: Chunks a slice holds even where the allocator's peak leaves no room for
#: them (19 MB of grouping at 131,072-edge chunks).
ROUNDS_MIN_SLICE_CHUNKS = 2
#: the four wave kernels share one source (and one library)
MEGA_NAME = "substream_match_mega"
WAVES_NAME = "substream_match_waves"
MEGA_UNPACKED_NAME = "substream_match_mega_unpacked"
WAVES_UNPACKED_NAME = "substream_match_waves_unpacked"
WAVE_NAMES = (MEGA_NAME, WAVES_NAME, MEGA_UNPACKED_NAME, WAVES_UNPACKED_NAME)
WAVES_LIBRARY = "substream_match_waves"
WAVES_SOURCE = _CSRC / "substream_match_waves.cu"
#: The wave kernels' schedule, compile-time constants of ``WAVES_SOURCE``:
#: one CTA of ``WAVE_THREADS`` threads walks the waves, a thread to a (slot,
#: lane), a slot taking :func:`wave_lanes` lanes of ``WAVE_CHUNK_BITS``
#: substreams each (one 64-bit word of the packed block, or of the unpacked
#: block's packed working copy); the last ``WAVE_STAGERS`` threads (a warp a
#: ring) copy the ids and passing counts of wave k + ``WAVE_AHEAD`` into
#: rings of ``WAVE_RING_SLOTS`` slots in shared memory during wave k, having
#: planned that range during wave k - 1, and the segment offsets
#: ``WAVE_OFFSET_AHEAD`` waves ahead into a ring of ``WAVE_OFFSET_RING``.
WAVE_THREADS = 512
WAVE_CHUNK_BITS = 64
WAVE_RING_SLOTS = 4096
WAVE_AHEAD = 3
WAVE_OFFSET_AHEAD = 8
WAVE_OFFSET_RING = 16
WAVE_STAGERS = 64
#: widest row the kernels take, in uint8 words (L <= 2048)
MAX_WIDTH = 256
#: widest unpacked row the kernels take, in int8 bytes (L <= 2048)
MAX_UNPACKED_WIDTH = 2048
#: Extra bit-block rows past ``n_pad`` for the wave kernels: row ``n_pad``
#: is the sacrificial row every padding slot points at; the band is 8
#: rows to keep the row count a multiple of 8.
SACRIFICIAL_ROWS = 8


def rounds_geometry(m: int, n_pad: int, budget: int = 0,
                    blocks: int = EDGE_ROUNDS_BLOCKS) -> tuple[int, int, int]:
    """(chunk, slice, vbits) of the rounds engine for ``m`` edges on
    ``n_pad`` rows, ``budget`` device bytes for the grouping and ``blocks``
    resident CTAs: chunks of as many edges as the CTAs hold (at most
    ``EDGE_ROUNDS_CHUNK``, at most ``m``); slices of whole chunks, grouped
    by one sort each, as many chunks as ``budget`` holds at
    ``ROUNDS_GROUP_BYTES`` an edge, at least ``ROUNDS_MIN_SLICE_CHUNKS``,
    and no more than the stream has or the int32 keys
    ``chunk << vbits | vertex`` number."""
    per_grid = blocks * EDGE_ROUNDS_THREADS * EDGE_ROUNDS_ITEMS // 2
    chunk = max(1, min(EDGE_ROUNDS_CHUNK, per_grid, m))
    vbits = max(1, (n_pad - 1).bit_length())
    by_memory = max(ROUNDS_MIN_SLICE_CHUNKS, budget // (ROUNDS_GROUP_BYTES * chunk))
    per_slice = max(1, min(-(-m // chunk), by_memory, 1 << (31 - vbits)))
    return chunk, per_slice * chunk, vbits


def group_budget(device) -> int:
    """Device bytes the rounds engine's grouping may take on ``device``
    without raising the process's peak: what the caching allocator's peak
    (``max_memory_allocated``) holds above what is allocated now. On the
    main path that is the room the blocking's argsorts left."""
    return max(0, torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device))


_ROUNDS_BLOCKS: dict[int, int] = {}


def rounds_blocks(device) -> int:
    """CTAs of the rounds engine that ``device`` (a CUDA device) holds
    resident at once, at most ``EDGE_ROUNDS_BLOCKS``: the SMs times the
    CTAs an SM fits (the CUDA occupancy query, once a device)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _ROUNDS_BLOCKS:
        fn = build.load_library(EDGES_LIBRARY, EDGES_SOURCE).substream_match_rounds_blocks
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(ctypes.byref(out))
        if err or out.value < 1:
            raise RuntimeError(f"{ROUNDS_NAME}: no cooperative grid on cuda:{index} "
                               f"(CUDA error {err}, {out.value} CTAs)")
        _ROUNDS_BLOCKS[index] = out.value
    return _ROUNDS_BLOCKS[index]


def _launcher(name: str = NAME):
    fn = getattr(build.load_library(EDGES_LIBRARY, EDGES_SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_tensors(expect):
    """Raise ``ValueError`` unless every ``(name, tensor, dtype, shape)`` has
    that type and shape, is contiguous and lies on the first one's device."""
    device = expect[0][1].device
    for name, t, dtype, shape in expect:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, {expect[0][0]} on {device}")


def _check_ids(ids, hi_ok: int):
    if ids.numel():
        lo, hi = (int(x) for x in torch.aminmax(ids))
        if lo < 0 or hi > hi_ok:
            raise ValueError(f"vertex ids span [{lo}, {hi}], outside [0, {hi_ok}]")


def _block_dtype(packed: bool) -> torch.dtype:
    return torch.uint8 if packed else torch.int8


def _check(edges, weights, thresholds, n_pad, mb_init, packed=True):
    m = edges.shape[0]
    width = thresholds.shape[-1]
    expect = [
        ("edges", edges, torch.int32, (m, 2)),
        ("weights", weights, torch.float32, (m,)),
        ("thresholds", thresholds, torch.float32, (8 if packed else 1, width)),
    ]
    if mb_init is not None:
        expect.append(("mb_init", mb_init, _block_dtype(packed), (n_pad, width)))
    _check_tensors(expect)
    _check_ids(edges, n_pad - 1)


class PlanRefusedError(ValueError):
    """A run the card cannot take, refused before anything is launched: a
    row wider than the kernels take (here), or a bit block and slot stream
    larger than the card's free memory (``ops._slot_plan``). The one failure
    that ``substream_match(on_plan_failure="fallback")`` absorbs on the
    card; a build, launch or operand error propagates."""


def _check_width(width: int, packed: bool):
    """Refuse, before a launch, a row width the card's kernels do not take:
    the packed wave kernels' and every unpacked kernel's. Too wide is a
    :class:`PlanRefusedError`; misaligned is the caller's fault
    (``ValueError``)."""
    step, most, unit = (8, MAX_WIDTH, "words") if packed else (16, MAX_UNPACKED_WIDTH, "bytes")
    if width % step or width > most:
        err = PlanRefusedError if width > most else ValueError
        raise err(
            f"row width {width} {unit}: the kernels take multiples of {step} up to "
            f"{most} (L <= {8 * MAX_WIDTH})"
        )


def edge_chunks(width: int, packed: bool) -> int:
    """CTAs of a per-edge kernel: one per ``EDGE_CHUNK_BITS`` substreams."""
    nbits = 8 * width if packed else width
    return max(1, -(-nbits // EDGE_CHUNK_BITS))


def _launch_edges(name, edges, weights, thresholds, mb):
    """Launch one of the per-edge kernels on the current stream over the
    bit block ``mb`` (updated in place; its rows may be wider than the
    thresholds' ``width``); returns assigned [m]. With more than one column
    chunk the CTAs combine ``assigned`` by atomicMax over -1."""
    launch = _launcher(name)
    m = edges.shape[0]
    width = thresholds.shape[1]
    assigned = torch.empty((m,), dtype=torch.int32, device=edges.device)
    if edge_chunks(width, name == NAME) > 1:
        assigned.fill_(-1)
    with torch.cuda.device(edges.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            edges.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
            mb.data_ptr(), assigned.data_ptr(), m, width, mb.shape[1], stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    build.launches[name] += 1
    return assigned


def substream_match_packed_plain(edges, weights, thresholds, n_pad: int, mb_init=None):
    """Plain PyTorch version of the kernel on its own operand shapes; runs
    where its tensors lie. The bit-plane thresholds [8, width] flatten to
    the lane order 8k+j, and their +inf pads never match."""
    return ref.substream_match_ref_packed(
        edges[:, 0], edges[:, 1], weights, thresholds.T.reshape(-1), n_pad,
        mb0=mb_init,
    )


def substream_match_packed(
    edges: torch.Tensor,  # int32 [m, 2]
    weights: torch.Tensor,  # float32 [m]; 0 marks padding/invalid edges
    thresholds: torch.Tensor,  # float32 [8, width]; thr[j, k] = substream 8k+j, +inf pads
    n_pad: int,
    mb_init: torch.Tensor | None = None,  # uint8 [n_pad, width] carried-in bits
):
    """Part 1 over the edges in the order given.

    Returns (assigned int32 [m], mb uint8 [n_pad, width]). ``mb_init``
    seeds the bit block instead of zeros. Raises ``ValueError`` on an
    operand of the wrong type, shape or device, on a vertex id outside
    ``[0, n_pad)``, and :class:`PlanRefusedError` on the card for
    ``width > MAX_WIDTH``.
    """
    _check(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type == "cpu":
        return substream_match_packed_plain(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type != "cuda":
        raise ValueError(f"no kernel for device {edges.device}")
    width = thresholds.shape[1]
    if width > MAX_WIDTH:
        raise PlanRefusedError(f"row width {width} words > {MAX_WIDTH} (L > {8 * MAX_WIDTH})")
    # the kernel moves whole 64-bit words: rows padded to 8 bytes, the pad kept at zero
    pitch = -(-width // 8) * 8
    mb = torch.zeros((n_pad, pitch), dtype=torch.uint8, device=edges.device)
    if mb_init is not None:
        mb[:, :width] = mb_init
    assigned = _launch_edges(NAME, edges, weights, thresholds, mb)
    return assigned, mb if pitch == width else mb[:, :width].contiguous()


def _rounds_launchers():
    lib = build.load_library(EDGES_LIBRARY, EDGES_SOURCE)
    keys, run = lib.substream_match_rounds_keys, lib.substream_match_rounds
    keys.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]
    run.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int] + [ctypes.c_void_p] * 3
    keys.restype = run.restype = ctypes.c_int
    return keys, run


def substream_match_rounds(
    edges: torch.Tensor,  # int32 [m, 2]
    weights: torch.Tensor,  # float32 [m]; 0 marks padding/invalid edges
    thresholds: torch.Tensor,  # float32 [8, width], width <= ROUNDS_MAX_WIDTH; +inf pads
    n_pad: int,
    mb_init: torch.Tensor | None = None,  # uint8 [n_pad, width] carried-in bits
    stats: torch.Tensor | None = None,  # int64 [2] on the card: chunks and rounds added
):
    """Part 1 over the edges in the order given, as
    :func:`substream_match_packed` computes it, bit for bit, on the whole
    card: chunks of consecutive edges, each grouped by vertex (one stable
    ``torch.sort`` of int32 keys per slice of chunks, sized by
    :func:`rounds_geometry` from :func:`group_budget` and
    :func:`rounds_blocks`) and matched in bit-parallel rounds of locally
    least edges by one cooperative launch per slice. The host waits on
    nothing.

    Returns (assigned int32 [m], mb uint8 [n_pad, width]). ``stats``, where
    given, gets the chunks and the rounds (summed over the chunks) added on
    the device. Raises ``ValueError`` as :func:`substream_match_packed` does,
    and for a row wider than ``ROUNDS_MAX_WIDTH`` words. On a CPU tensor
    it runs the packed kernel's plain version.
    """
    _check(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type == "cpu":
        return substream_match_packed_plain(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type != "cuda":
        raise ValueError(f"no kernel for device {edges.device}")
    width = thresholds.shape[1]
    if width > ROUNDS_MAX_WIDTH:
        raise ValueError(f"row width {width} words > {ROUNDS_MAX_WIDTH}: the rounds engine "
                         f"takes one 64-bit word a row (L <= 64)")
    dev = edges.device
    m = edges.shape[0]
    mb = torch.zeros((n_pad, ROUNDS_MAX_WIDTH), dtype=torch.uint8, device=dev)
    if mb_init is not None:
        mb[:, :width] = mb_init
    assigned = torch.empty((m,), dtype=torch.int32, device=dev)
    if m:
        keys_fn, run_fn = _rounds_launchers()
        scratch = torch.empty((ROUNDS_SCRATCH_WORDS,), dtype=torch.int64, device=dev)
        if stats is None:
            stats = torch.zeros((2,), dtype=torch.int64, device=dev)
        chunk, slice_edges, vbits = rounds_geometry(m, n_pad, group_budget(dev),
                                                    rounds_blocks(dev))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            for lo in range(0, m, slice_edges):
                n = min(m, lo + slice_edges) - lo
                part = edges[lo:lo + n]
                keys = torch.empty((2 * n,), dtype=torch.int32, device=dev)
                err = keys_fn(part.data_ptr(), keys.data_ptr(), n, chunk, vbits, stream)
                if err:
                    raise RuntimeError(f"{ROUNDS_KEYS_NAME} launch failed: CUDA error {err}")
                build.launches[ROUNDS_KEYS_NAME] += 1
                keys, perm = torch.sort(keys, stable=True)
                scratch[EDGE_ROUNDS_CHUNK:].zero_()
                err = run_fn(
                    part.data_ptr(), weights[lo:].data_ptr(), thresholds.data_ptr(),
                    mb.data_ptr(), assigned[lo:].data_ptr(), keys.data_ptr(), perm.data_ptr(),
                    n, chunk, width, vbits, scratch.data_ptr(), stats.data_ptr(), stream,
                )
                if err:
                    raise RuntimeError(f"{ROUNDS_NAME} launch failed: CUDA error {err}")
                build.launches[ROUNDS_NAME] += 1
                del keys, perm  # before the next slice's sort
    return assigned, mb if width == ROUNDS_MAX_WIDTH else mb[:, :width].contiguous()


def _unpacked_block(rows: int, width: int, mb_init, device) -> torch.Tensor:
    """The unpacked kernels' bit block: zeros, or ``mb_init`` with every
    non-zero byte set to 1 (a non-zero byte is a set bit)."""
    if mb_init is None:
        return torch.zeros((rows, width), dtype=torch.int8, device=device)
    return mb_init.ne(0).to(torch.int8)


def substream_match_unpacked_plain(edges, weights, thresholds, n_pad: int, mb_init=None):
    """Plain PyTorch version of :func:`substream_match_unpacked` on its own
    operand shapes, one edge per loop step (the dense oracle); runs where
    its tensors lie. The +inf pads of the [1, width] lanes never match."""
    return ref.substream_match_ref(
        edges[:, 0], edges[:, 1], weights, thresholds[0], n_pad, mb0=mb_init,
    )


def substream_match_unpacked(
    edges: torch.Tensor,  # int32 [m, 2]
    weights: torch.Tensor,  # float32 [m]; 0 marks padding/invalid edges
    thresholds: torch.Tensor,  # float32 [1, width]; lane l = substream l, +inf pads
    n_pad: int,
    mb_init: torch.Tensor | None = None,  # int8 [n_pad, width] carried-in bits
):
    """Part 1 over the edges in the order given, one int8 byte per substream.

    Returns (assigned int32 [m], mb int8 [n_pad, width] of 0/1). ``mb_init``
    seeds the bit block instead of zeros; a non-zero byte there is a set
    bit. Raises ``ValueError`` as :func:`substream_match_packed` does, and
    on the card for a width that is not a multiple of 16 or above
    ``MAX_UNPACKED_WIDTH``.
    """
    _check(edges, weights, thresholds, n_pad, mb_init, packed=False)
    if edges.device.type == "cpu":
        return substream_match_unpacked_plain(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type != "cuda":
        raise ValueError(f"no kernel for device {edges.device}")
    _check_width(thresholds.shape[1], packed=False)
    mb = _unpacked_block(n_pad, thresholds.shape[1], mb_init, edges.device)
    return _launch_edges(UNPACKED_NAME, edges, weights, thresholds, mb), mb


# --------------------------------------------------------------------------
# The wave kernels: a fill-packed wave schedule, one wave after another.


def wave_lanes(lanes: int) -> int:
    """Lanes (threads) per slot of the wave kernels' walk for rows of
    ``lanes`` substreams (``8 * width`` packed, ``width`` unpacked): the
    next power of two >= the row's ``WAVE_CHUNK_BITS``-substream words."""
    words = max(1, -(-lanes // WAVE_CHUNK_BITS))
    return 1 << (words - 1).bit_length()


def _waves_launcher(name: str):
    fn = getattr(build.load_library(WAVES_LIBRARY, WAVES_SOURCE), name)
    ints = [ctypes.c_int] * (3 if name in (MEGA_NAME, MEGA_UNPACKED_NAME) else 2)  # + bslots
    # ids, weights, thr, mb, [work,] counts, assigned; total, rows, width, stream
    ptrs = [ctypes.c_void_p] * (7 if name in (MEGA_UNPACKED_NAME, WAVES_UNPACKED_NAME) else 6)
    fn.argtypes = [ctypes.c_void_p, *ints, *ptrs, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_seg_offsets(seg_offsets, total: int, seg: int, align: int):
    """The schedule's wave bounds: non-decreasing segment rows from 0, each
    a multiple of ``align`` (tiles never straddle a wave), inside the
    ``total`` slots."""
    offs = seg_offsets.cpu()
    if offs.numel() == 0 or int(offs[0]) != 0:
        raise ValueError("seg_offsets must start at 0")
    if bool((offs[1:] < offs[:-1]).any()) or bool((offs % align != 0).any()):
        raise ValueError(f"seg_offsets must be non-decreasing multiples of {align}")
    if int(offs[-1]) * seg > total:
        raise ValueError(f"seg_offsets end at slot {int(offs[-1]) * seg} > {total} slots")


def _bit_block(n_pad: int, width: int, mb_init, device, packed: bool = True):
    """The wave kernels' bit block, ``n_pad + SACRIFICIAL_ROWS`` rows."""
    rows = n_pad + SACRIFICIAL_ROWS
    if not packed:
        return _unpacked_block(rows, width, mb_init, device)
    if mb_init is None:
        return torch.zeros((rows, width), dtype=torch.uint8, device=device)
    return mb_init.clone()


def _prefix_te_table(width: int, device) -> torch.Tensor:
    """[8 * width + 1, width] uint8: row c = the packed L-bit prefix mask
    with the lowest ``c`` bits set (bit j of word k = substream 8k+j).
    Sorted thresholds make every eligibility word such a prefix."""
    c = torch.arange(8 * width + 1, device=device)[:, None]
    k = torch.arange(width, device=device)[None, :]
    nbits = (c - 8 * k).clamp(0, 8)
    return ((1 << nbits) - 1).to(torch.uint8)


def _high_bit_table(width: int, device) -> torch.Tensor:
    """[256] int32: floor(log2) of a uint8 from its float32 exponent, and a
    sentinel for 0 low enough to stay below -1 after the word offsets
    (8k < 8 * width). The TPU kernel's fixed -1024 holds only up to 128
    words (L <= 1024): past that an edge that adds nothing would read as
    assigned."""
    i = torch.arange(256, dtype=torch.float32, device=device)
    e = (i.view(torch.int32) >> 23) - 127
    return torch.where(i > 0, e, -8 * width - 1).to(torch.int32)


def _check_mega(uv, weights, thresholds, seg_offsets, n_pad, seg, seg_block, mb_init, packed):
    total = weights.shape[0]
    nbits = thresholds.shape[0]
    if seg < 1 or seg_block < 1 or total % (seg * seg_block):
        raise ValueError(f"{total} slots are not whole tiles of {seg_block} x {seg}")
    if packed and nbits % 8:
        raise ValueError(f"thresholds: {nbits} bits are not whole uint8 words")
    expect = [
        ("uv", uv, torch.int32, (2 * total,)),
        ("weights", weights, torch.float32, (total,)),
        ("thresholds", thresholds, torch.float32, (nbits,)),
        ("seg_offsets", seg_offsets, torch.int32, (seg_offsets.shape[0],)),
    ]
    if mb_init is not None:
        width = nbits // 8 if packed else nbits
        expect.append(("mb_init", mb_init, _block_dtype(packed), (n_pad + SACRIFICIAL_ROWS, width)))
    _check_tensors(expect)
    if nbits and bool((thresholds[1:] < thresholds[:-1]).any() | thresholds.isnan().any()):
        raise ValueError("thresholds must be non-decreasing: eligibility is a prefix count")
    _check_seg_offsets(seg_offsets, total, seg, seg_block)
    _check_ids(uv, n_pad)


def substream_match_mega_plain(
    uv, weights, thresholds, seg_offsets, n_pad: int, seg: int, seg_block: int, mb_init=None,
    packed: bool = True,
):
    """Plain PyTorch version of :func:`substream_match_mega`, one tile per
    loop step as the TPU kernels: count the passing thresholds, make the
    prefix eligibility (packed: look the prefix word up; unpacked: the
    lanes below the count), gather the tile's rows, update, scatter, and
    take the highest substream (packed: from the log2 table)."""
    dev = uv.device
    total = weights.shape[0]
    bslots = seg_block * seg
    width = thresholds.shape[0] // 8 if packed else thresholds.shape[0]
    mb = _bit_block(n_pad, width, mb_init, dev, packed)
    tiles = uv.view(-1, 2, bslots)
    loop = (tiles[:, 0] == tiles[:, 1]).reshape(-1)
    cnt = (weights[:, None] >= thresholds[None, :]).sum(dim=1)
    if packed:
        te_all = torch.where(loop[:, None], 0, _prefix_te_table(width, dev)[cnt]).to(torch.uint8)
        high_bit = _high_bit_table(width, dev)
        word_off = 8 * torch.arange(width, dtype=torch.int32, device=dev)
    else:
        lane = torch.arange(width, device=dev)
        te_all = ((lane[None, :] < cnt[:, None]) & ~loop[:, None]).to(torch.int8)
    assigned = torch.full((total,), -1, dtype=torch.int32, device=dev)
    for t in range(int(seg_offsets[-1]) // seg_block):
        idx = uv[2 * bslots * t : 2 * bslots * (t + 1)].long()
        rows = mb[idx]
        mbu, mbw = rows[:bslots], rows[bslots:]
        te = te_all[bslots * t : bslots * (t + 1)]
        if packed:
            add = te & ~(mbu | mbw)
            best = (high_bit[add.long()] + word_off).amax(dim=1).clamp_min(-1)
        else:
            add = te & ((mbu == 0) & (mbw == 0)).to(torch.int8)
            best = highest_lane(add != 0)
        mb[idx] = rows | torch.cat([add, add])
        assigned[bslots * t : bslots * (t + 1)] = best.to(torch.int32)
    return assigned, mb[:n_pad]


def substream_match_mega(
    uv: torch.Tensor,  # int32 [2 * total]; per tile all u's, then all v's
    weights: torch.Tensor,  # float32 [total]; 0 on padding and self-loop slots
    thresholds: torch.Tensor,  # float32 [nbits], sorted, +inf pads
    seg_offsets: torch.Tensor,  # int32 [num_waves + 1], multiples of seg_block
    n_pad: int,
    seg: int,
    seg_block: int,
    mb_init: torch.Tensor | None = None,  # [n_pad + SACRIFICIAL_ROWS, width]
    packed: bool = True,
):
    """Part 1 over the block-aligned slot stream of a wave schedule
    (:func:`repro_torch.graph.waves.block_aligned_layout`), wave by wave.

    A tile is ``seg_block * seg`` slots of one wave. Padding and self-loop
    slots point at the sacrificial row ``n_pad`` with ``w = 0``. The
    layout is uint8 bit planes, ``nbits = 8 * width`` thresholds
    (``packed``), or int8 bytes, ``nbits = width`` (``packed=False``, the
    TPU's ``_kernel_waves_mega``). Returns (assigned int32 [total], -1 on
    padding; mb [n_pad, width] in the layout's type). Raises
    ``ValueError`` on an operand of the wrong type, shape or device, on
    decreasing thresholds, on wave bounds that are not whole tiles, on an
    id outside ``[0, n_pad]``, and on the card for a width the kernel
    does not take (``_check_width``).
    """
    _check_mega(uv, weights, thresholds, seg_offsets, n_pad, seg, seg_block, mb_init, packed)
    if uv.device.type == "cpu":
        return substream_match_mega_plain(
            uv, weights, thresholds, seg_offsets, n_pad, seg, seg_block, mb_init, packed)
    if uv.device.type != "cuda":
        raise ValueError(f"no kernel for device {uv.device}")
    return _launch_waves(
        MEGA_NAME if packed else MEGA_UNPACKED_NAME, seg_offsets, seg, (seg * seg_block,),
        uv, weights, thresholds, n_pad,
        thresholds.shape[0] // 8 if packed else thresholds.shape[0], mb_init, packed,
    )


def _launch_waves(name, seg_offsets, seg, extra, ids, weights, lanes, n_pad, width,
                  mb_init, packed):
    """Launch one of the wave kernels (``extra``: mega's tile size) on the
    current stream over ``lanes``, one float32 threshold per substream;
    returns (assigned [total], mb [n_pad, width]). Every kernel takes an
    int32 passing count per slot as scratch; the unpacked ones also their
    packed working copy of the block, one int64 word per 64 substreams of a
    row. The packed block is its own working copy."""
    _check_width(width, packed)
    launch = _waves_launcher(name)
    mb = _bit_block(n_pad, width, mb_init, ids.device, packed)
    total = weights.shape[0]
    assigned = torch.full((total,), -1, dtype=torch.int32, device=ids.device)
    counts = torch.empty((total,), dtype=torch.int32, device=ids.device)
    block = [mb.data_ptr()]
    if not packed:
        work = torch.empty((mb.shape[0], -(-width // WAVE_CHUNK_BITS)), dtype=torch.int64,
                           device=ids.device)
        block.append(work.data_ptr())
    with torch.cuda.device(ids.device):
        err = launch(
            seg_offsets.data_ptr(), seg_offsets.shape[0] - 1, seg, *extra,
            ids.data_ptr(), weights.data_ptr(), lanes.data_ptr(), *block, counts.data_ptr(),
            assigned.data_ptr(), total, mb.shape[0], width,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    build.launches[name] += 1
    return assigned, mb[:n_pad]


def _check_waves(edges, weights, thresholds, seg_offsets, n_pad, seg, mb_init, packed):
    total = weights.shape[0]
    width = thresholds.shape[-1]
    if seg < 1 or total % seg:
        raise ValueError(f"{total} slots are not whole segments of {seg}")
    expect = [
        ("edges", edges, torch.int32, (total, 2)),
        ("weights", weights, torch.float32, (total,)),
        ("thresholds", thresholds, torch.float32, (8 if packed else 1, width)),
        ("seg_offsets", seg_offsets, torch.int32, (seg_offsets.shape[0],)),
    ]
    if mb_init is not None:
        expect.append(("mb_init", mb_init, _block_dtype(packed), (n_pad + SACRIFICIAL_ROWS, width)))
    _check_tensors(expect)
    _check_seg_offsets(seg_offsets, total, seg, 1)
    _check_ids(edges, n_pad)


def substream_match_waves_plain(
    edges, weights, thresholds, seg_offsets, n_pad: int, seg: int, mb_init=None,
    packed: bool = True,
):
    """Plain PyTorch version of :func:`substream_match_waves`, one segment
    per loop step as the TPU kernels: eligibility (packed: bit planes;
    unpacked: one compare per lane), cleared on self-loops, gather,
    update, in-place row scatter, highest substream."""
    dev = edges.device
    width = thresholds.shape[1]
    mb = _bit_block(n_pad, width, mb_init, dev, packed)
    shift = torch.arange(8, dtype=torch.uint8, device=dev)
    bit_of = 8 * torch.arange(width, device=dev)[:, None] + torch.arange(8, device=dev)
    assigned = torch.full((weights.shape[0],), -1, dtype=torch.int32, device=dev)
    for i in range(int(seg_offsets[-1])):
        sl = slice(i * seg, (i + 1) * seg)
        u, v = edges[sl, 0].long(), edges[sl, 1].long()
        mbu, mbv = mb[u], mb[v]
        if packed:
            planes = weights[sl, None, None] >= thresholds[None]  # [seg, 8, width]
            te = (planes.to(torch.uint8) << shift[:, None]).sum(dim=1).to(torch.uint8)
            te = torch.where((u != v)[:, None], te, 0).to(torch.uint8)
            add = te & ~mbu & ~mbv
            hit = ((add[:, :, None] >> shift) & 1).bool()  # [seg, width, 8]
            best = torch.where(hit, bit_of, -1).amax(dim=(1, 2)).to(torch.int32)
        else:
            te = (weights[sl, None] >= thresholds) & (u != v)[:, None]  # [seg, width]
            add = (te & (mbu == 0) & (mbv == 0)).to(torch.int8)
            best = highest_lane(add != 0)
        mb[u] = mbu | add
        mb[v] = mbv | add
        assigned[sl] = best
    return assigned, mb[:n_pad]


def substream_match_waves(
    edges: torch.Tensor,  # int32 [total, 2]; padding slots are (n_pad, n_pad)
    weights: torch.Tensor,  # float32 [total]; 0 on padding slots
    thresholds: torch.Tensor,  # float32 [8, width] bit planes, or [1, width] lanes; +inf pads
    seg_offsets: torch.Tensor,  # int32 [num_waves + 1]: the schedule's segment rows
    n_pad: int,
    seg: int,
    mb_init: torch.Tensor | None = None,  # [n_pad + SACRIFICIAL_ROWS, width]
    packed: bool = True,
):
    """Part 1 over the fill-packed slot stream of a wave schedule
    (:class:`repro_torch.graph.waves.WaveSchedule`), wave by wave; the
    kernel tests ``u != v`` itself. The layout is uint8 bit planes with
    ``thr[j, k]`` = substream ``8k + j`` (``packed``) or int8 bytes with
    one threshold lane each (``packed=False``, the TPU's
    ``_kernel_waves``). Returns (assigned int32 [total], -1 on padding;
    mb [n_pad, width] in the layout's type). Raises ``ValueError`` as
    :func:`substream_match_mega` does, bar the threshold order.
    """
    _check_waves(edges, weights, thresholds, seg_offsets, n_pad, seg, mb_init, packed)
    if edges.device.type == "cpu":
        return substream_match_waves_plain(
            edges, weights, thresholds, seg_offsets, n_pad, seg, mb_init, packed)
    if edges.device.type != "cuda":
        raise ValueError(f"no kernel for device {edges.device}")
    # one threshold per lane: the bit planes [8, width] as lane 8k+j = thr[j, k] (the
    # unpacked [1, width] lanes stay as they are)
    lanes = thresholds.t().contiguous()
    return _launch_waves(
        WAVES_NAME if packed else WAVES_UNPACKED_NAME, seg_offsets, seg, (), edges, weights,
        lanes, n_pad, thresholds.shape[1], mb_init, packed,
    )
