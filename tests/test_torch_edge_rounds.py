"""The rounds engine's schedule, modelled in numpy and held to the JAX oracles.

``csrc/substream_match_edges.cu``'s rounds engine takes the packed per-edge
contract for rows of one 64-bit word (L <= 64) in chunks of consecutive
edges, groups each chunk's incidences by vertex with one stable sort per
slice of chunks, and matches a chunk in bit-parallel rounds of locally
least edges: the kill, a segmented exclusive OR-scan along each vertex's
run (inside each CTA's tile, then a look-back over the tiles), the winners
and their atomicOr into the block. :mod:`repro_torch.testing.rounds_model`
follows those rules with the constants of ``kernel.py``; here it is held
bit for bit, no tolerance, in ``assigned`` and the block, to the JAX
package's packed oracle (``repro.kernels.substream_match.ref``): on the
zoo, RMAT 8/10, a hub, self-loops and repeated pairs, streams of m in {0,
1, C - 1, C, C + 1, 3C + 5} (C = ``EDGE_ROUNDS_CHUNK``), at L in {1, 13,
64}, with unsorted thresholds and with carried bits; and with short chunks
and tiles of a few incidences, so that the look-back and the chunk and
slice bounds fall inside short streams. Besides: the geometry, the
constants against the source, the route and its counters.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.substream_match.ref import substream_match_ref_packed as jref_packed
from repro_torch import obs
from repro_torch.core import EdgeStream, SubstreamConfig
from repro_torch.graph.generators import uniform_weights
from repro_torch.kernels.substream_match import kernel, ops
from repro_torch.kernels.substream_match.ops import kernel_inputs, substream_match
from repro_torch.testing.cases import WINDOW, ZOO, Case, permuted_lanes, rmat_case
from repro_torch.testing.rounds_model import rounds_model, seg_exclusive_or, tiled_scan

C = kernel.EDGE_ROUNDS_CHUNK
LONG = {"Cm1": C - 1, "C": C, "Cp1": C + 1, "3Cp5": 3 * C + 5}


def _long(m, L):
    """m edges on 20,000 vertices: a hub on one edge in twenty, a self-loop
    in a hundred, and one edge in fifty a copy of an earlier one (turned
    round every other time), so runs span tiles and pairs repeat."""
    rng = np.random.default_rng(m)
    n = 20_000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    hub = rng.random(m) < 0.05
    src[hub] = 7
    loop = rng.random(m) < 0.01
    dst[loop] = src[loop]
    again = np.flatnonzero(rng.random(m) < 0.02)
    back = again - rng.integers(1, 5000, again.size)
    keep = back >= 0
    again, back = again[keep], back[keep]
    turn = np.arange(again.size) % 2 == 1
    src[again], dst[again] = np.where(turn, dst[back], src[back]), np.where(turn, src[back], dst[back])
    eps = 0.1
    return Case(n, src.astype(np.int32), dst.astype(np.int32), uniform_weights(m, L, eps, seed=m),
                L, eps, 0)


def _case(name):
    """(case, carried bits?, unsorted thresholds?) by name: ``-L<L>``,
    ``-mb0`` and ``-unsorted`` modifiers."""
    base, *mods = name.split("-")
    L = next((int(x[1:]) for x in mods if x.startswith("L")), 64)
    if base.startswith("zoo_"):
        c = ZOO[base[4:]]()
    elif base == "rmat8":
        c = rmat_case(8, edge_factor=8, L=16, pad=3)
    elif base == "rmat10":
        c = rmat_case(10, edge_factor=4, L=L)
    elif base in LONG:
        c = _long(LONG[base], L)
    else:
        c = WINDOW[base](L)
    return c, "mb0" in mods, "unsorted" in mods


SMALL = ([f"zoo_{k}" for k in ZOO] + ["rmat8", "rmat10", "rmat10-L13", "rmat10-L1"]
         + ["hub", "hub-L13", "hub-L1", "self_loops_mid", "repeat_d33", "repeat_d64-L13",
            "m0", "m1", "m33-L1"]
         + ["hub-unsorted", "rmat10-unsorted", "zoo_dense_small-unsorted"]
         + ["hub-mb0", "rmat10-mb0", "m33-mb0", "hub-L13-unsorted-mb0"])
LONG_CASES = (list(LONG) + ["Cp1-L13", "Cp1-L1", "Cp1-unsorted", "Cp1-mb0", "3Cp5-mb0"])


@functools.lru_cache(maxsize=None)
def _operands(name):
    """The packed per-edge operands of a case on the CPU. Carried bits come
    from the oracle over a second stream on the same vertices."""
    c, carried, unsorted = _case(name)
    stream = EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad, device="cpu")
    cfg = SubstreamConfig(n=c.n, L=c.L, eps=c.eps)
    edges, w, thr, n_pad, _ = kernel_inputs(stream, cfg)
    if unsorted:
        thr = permuted_lanes(thr, c.L)
    mb0 = None
    if carried:
        rng = np.random.default_rng(len(name))
        pre = torch.from_numpy(rng.integers(0, c.n, (3 * c.n + 8, 2)).astype(np.int32))
        pre_w = torch.from_numpy(rng.uniform(1, float(c.w.max(initial=2.0)), pre.shape[0])
                                 .astype(np.float32))
        _, mb0 = _oracle(pre, pre_w, thr, n_pad, None)
        mb0 = torch.from_numpy(mb0.copy())
    return edges, w, thr, n_pad, mb0


def _oracle(edges, w, thr, n_pad, mb0):
    """The JAX package's packed oracle on the operands (numpy out)."""
    e = jnp.asarray(edges.numpy())
    a, mb = jref_packed(e[:, 0], e[:, 1], jnp.asarray(w.numpy()),
                        jnp.asarray(thr.numpy().T.reshape(-1)), n_pad,
                        mb0=None if mb0 is None else jnp.asarray(mb0.numpy()))
    return np.asarray(a), np.asarray(mb)


@functools.lru_cache(maxsize=None)
def _want(name):
    return _oracle(*_operands(name))


@pytest.mark.parametrize("name", SMALL + LONG_CASES)
def test_rounds_model_matches_oracle(name):
    got_a, got_mb, chunks, rounds = rounds_model(*_operands(name))
    want_a, want_mb = _want(name)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)
    assert chunks == -(-_operands(name)[0].shape[0] // C)
    assert rounds >= (want_a >= 0).any()


@pytest.mark.parametrize("chunk, per_slice, tile", [(1, 1, 2), (5, 3, 4), (33, 2, 8), (64, 4, 16)])
@pytest.mark.parametrize("name", ["hub", "hub-L13-unsorted-mb0", "rmat10", "repeat_d33",
                                  "self_loops_mid", "zoo_duplicates", "zoo_star"])
def test_short_chunks_and_tiles_match_oracle(name, chunk, per_slice, tile):
    """The look-back across many tiles, runs that span tiles and chunks, and
    slices of several chunks, inside short streams."""
    edges, w, thr, n_pad, mb0 = _operands(name)
    vbits = max(1, (n_pad - 1).bit_length())
    got_a, got_mb, chunks, _ = rounds_model(edges, w, thr, n_pad, mb0,
                                            geometry=(chunk, chunk * per_slice, vbits), tile=tile)
    want_a, want_mb = _want(name)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)
    assert chunks == -(-edges.shape[0] // chunk)


@pytest.mark.parametrize("name", SMALL)
def test_rounds_wrapper_runs_its_plain_version_on_cpu(name):
    edges, w, thr, n_pad, mb0 = _operands(name)
    got_a, got_mb = kernel.substream_match_rounds(edges, w, thr, n_pad, mb0)
    want_a, want_mb = _want(name)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_mb.numpy(), want_mb)


@pytest.mark.parametrize("seed, tile", [(0, 4), (1, 8), (2, 64), (3, 2048)])
def test_tiled_scan_is_the_segmented_scan(seed, tile):
    """The tiles' own scans plus the look-back equal one scan of the chunk
    and a plain loop, with runs longer than several tiles."""
    rng = np.random.default_rng(seed)
    n = 5000
    val = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
    val[rng.random(n) < 0.5] = 0
    head = rng.random(n) < (0.002 if seed % 2 else 0.2)
    head[0] = True
    want = np.zeros(n, np.uint64)
    run = np.uint64(0)
    for i in range(n):
        if head[i]:
            run = np.uint64(0)
        want[i] = run
        run |= val[i]
    np.testing.assert_array_equal(seg_exclusive_or(val, head), want)
    np.testing.assert_array_equal(tiled_scan(val, head, tile), want)


@pytest.mark.parametrize("m, n_pad, budget, blocks, want", [
    (1, 8, 0, 128, (1, 1, 3)),
    (100, 1 << 20, 0, 128, (100, 100, 20)),
    (C, 1 << 16, 0, 128, (C, C, 16)),
    (C + 1, 1 << 16, 0, 128, (C, 2 * C, 16)),  # no room: the floor of two chunks
    (2_431_328, 1 << 16, 11 * 2_431_328, 128, (C, 2 * C, 16)),  # kron48.s16-jobs
    (44_350_400, 1 << 20, 11 * 44_350_400, 128, (C, 50 * C, 20)),
    (1 << 27, 1 << 23, 1 << 40, 128, (C, 256 * C, 23)),  # the keys' int32 bound
    (1 << 30, 1 << 28, 0, 128, (C, 2 * C, 28)),
    (1 << 22, 1 << 20, 0, 114, (114 * 1024, 2 * 114 * 1024, 20)),  # a card of 114 SMs
])
def test_rounds_geometry(m, n_pad, budget, blocks, want):
    assert kernel.rounds_geometry(m, n_pad, budget, blocks) == want
    chunk, slice_edges, vbits = want
    assert slice_edges % chunk == 0 and (slice_edges // chunk) << vbits <= 2**31
    assert 2 * chunk <= blocks * kernel.EDGE_ROUNDS_THREADS * kernel.EDGE_ROUNDS_ITEMS


def test_round_constants_match_the_source():
    """kernel.py's constants are the CUDA source's compile-time constants,
    and the library has the engine's three entries."""
    src = kernel.EDGES_SOURCE.read_text()
    want = {"kRoundThreads": kernel.EDGE_ROUNDS_THREADS, "kRoundItems": kernel.EDGE_ROUNDS_ITEMS,
            "kRoundBlocks": kernel.EDGE_ROUNDS_BLOCKS, "kRoundChunk": kernel.EDGE_ROUNDS_CHUNK}
    for name, value in want.items():
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)], name
    assert 2 * kernel.EDGE_ROUNDS_CHUNK == (kernel.EDGE_ROUNDS_BLOCKS * kernel.EDGE_ROUNDS_THREADS
                                            * kernel.EDGE_ROUNDS_ITEMS)
    for entry in (kernel.ROUNDS_NAME, kernel.ROUNDS_KEYS_NAME, "substream_match_rounds_blocks"):
        assert f'extern "C" int {entry}(' in src


@pytest.mark.parametrize("device, packed, width, want", [
    ("cuda", True, 8, "rounds_engine"),
    ("cuda:0", True, 8, "rounds_engine"),
    ("cuda", True, 1, "rounds_engine"),
    ("cuda", True, 16, "walker"),  # L > 64
    ("cuda", False, 64, "walker"),  # the unpacked layout
    ("cpu", True, 8, "walker"),  # the plain version
    ("cpu", False, 8, "walker"),
])
def test_edges_route(device, packed, width, want):
    assert ops.edges_route(device, packed, width) == want


def _stream_cfg(name):
    c, _, _ = _case(name)
    return (EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad, device="cpu"),
            SubstreamConfig(n=c.n, L=c.L, eps=c.eps))


def test_route_counters_count_the_walker_on_cpu():
    tel = obs.Telemetry()
    for name in ("hub", "rmat10"):
        substream_match(*_stream_cfg(name), device="cpu", telemetry=tel)
    assert tel.counters.get("kernel_edges.walker.calls") == 2
    assert tel.counters.get("kernel_edges.rounds_engine.calls") == 0
    assert tel.counters.get("kernel_edges.chunks") == 0
    execute = [e for e in tel.chrome_trace()["traceEvents"] if e["name"] == "kernel_edges.execute"]
    assert len(execute) == 2 and all("rounds" not in e.get("args", {}) for e in execute)


def test_rounds_route_reads_its_counters_once(monkeypatch):
    """On the rounds route an enabled session counts the route, adds the
    engine's chunks and rounds to ``kernel_edges.chunks`` / ``.rounds`` and
    notes them on the ``execute`` span; the result is the engine's. The
    engine is the model here (its stats as the card's kernel adds them)."""
    def model_engine(args, stats=None):
        a, mb, chunks, rounds = rounds_model(*args, geometry=(37, 74, 10), tile=8)
        if stats is not None:
            stats += torch.tensor([chunks, rounds])
        return torch.from_numpy(a), torch.from_numpy(mb)

    monkeypatch.setattr(ops, "edges_route", lambda *a: "rounds_engine")
    monkeypatch.setattr(ops, "_rounds_device", model_engine)
    tel = obs.Telemetry()
    stream, cfg = _stream_cfg("rmat10")
    got = substream_match(stream, cfg, device="cpu", telemetry=tel)
    monkeypatch.undo()
    want = substream_match(stream, cfg, device="cpu")
    assert torch.equal(got.assigned, want.assigned) and torch.equal(got.mb_packed, want.mb_packed)
    m = stream.num_edges
    assert tel.counters.get("kernel_edges.rounds_engine.calls") == 1
    assert tel.counters.get("kernel_edges.walker.calls") == 0
    assert tel.counters.get("kernel_edges.chunks") == -(-m // 37)
    rounds = tel.counters.get("kernel_edges.rounds")
    assert rounds > 0
    (execute,) = [e for e in tel.chrome_trace()["traceEvents"] if e["name"] == "kernel_edges.execute"]
    assert execute["args"]["chunks"] == -(-m // 37) and execute["args"]["rounds"] == rounds
    assert execute["args"]["edges"] == m


@pytest.mark.parametrize("kind", ["failing", "flaky"])
def test_fault_injection_reaches_the_rounds_route(monkeypatch, kind):
    """``faultline``'s ``edges_device`` target makes the per-edge launch
    fail on either route: on the rounds route its seam raises too, and a
    flake counts the two seams' calls together."""
    from repro_torch.testing import faultline

    monkeypatch.setattr(ops, "edges_route", lambda *a: "rounds_engine")
    stream, cfg = _stream_cfg("hub")
    if kind == "failing":
        with faultline.failing("edges_device"), pytest.raises(faultline.InjectedFailure):
            substream_match(stream, cfg, device="cpu")
        return
    want = substream_match(stream, cfg, device="cpu")
    with faultline.flaky("edges_device", times=1):
        with pytest.raises(faultline.TransientFlake):
            substream_match(stream, cfg, device="cpu")
        ops._edges_device(kernel_inputs(stream, cfg), True)  # the walker's seam: call 2
        got = substream_match(stream, cfg, device="cpu")
    assert torch.equal(got.assigned, want.assigned)
