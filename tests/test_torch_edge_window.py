"""The per-edge kernels' schedule, modelled in numpy and held to the JAX oracles.

The CUDA kernels of ``csrc/substream_match_edges.cu`` walk the stream in
batches of ``EDGE_BATCH`` edges, load the bit-block rows of a batch
``EDGE_PREFETCH`` batch ahead, forward the post-values of the latest toucher
in the window (the previous batches since the load and the earlier lanes of
the batch), resolve a batch in rounds until its post-values stop changing,
write back each vertex the batch changed once from its last touch, and run
one walker per ``EDGE_CHUNK_BITS`` substreams. The model
below follows those rules with the constants of ``kernel.py``, and asserts
on the way that each row written back replaces exactly the value the batch
started from. It and the kernels' plain versions are held bit for bit, no
tolerance, to the JAX package's pure oracles
(``repro.kernels.substream_match.ref``) in both layouts: on the zoo, RMAT
8/10, and streams aimed at the window (a hub, pairs that come back 31 to 65
edges later, self-loops inside a batch, m in {0, 1, 31, 32, 33}), at L in
{13, 64, 65, 300, 2048}, with and without carried bits.
"""
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.substream_match.ref import (
    substream_match_ref as jref,
    substream_match_ref_packed as jref_packed,
)
from repro_torch.core import EdgeStream, SubstreamConfig
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import kernel_inputs
from repro_torch.testing.cases import WINDOW, ZOO, rmat_case

B, D, CHUNK = kernel.EDGE_BATCH, kernel.EDGE_PREFETCH, kernel.EDGE_CHUNK_BITS
U64 = np.uint64


def _words(block: np.ndarray, packed: bool, nchunks: int) -> np.ndarray:
    """uint64 [chunks, rows]: chunk c of every row, bit s = substream 64c + s."""
    rows = block.shape[0]
    if packed:
        pad = np.zeros((rows, 8 * nchunks), np.uint8)
        pad[:, : block.shape[1]] = block
        return pad.view("<u8").T.copy()
    bits = np.zeros((rows, CHUNK * nchunks), bool)
    bits[:, : block.shape[1]] = block != 0
    return np.packbits(bits, axis=1, bitorder="little").view("<u8").T.copy()


def _block(words: np.ndarray, packed: bool, width: int) -> np.ndarray:
    """Back from :func:`_words` to the layout's block [rows, width]."""
    raw = np.ascontiguousarray(words.T).view(np.uint8)
    if packed:
        return raw[:, :width].copy()
    return np.unpackbits(raw, axis=1, bitorder="little")[:, :width].astype(np.int8)


def _eligibility(w, u, v, thr, packed: bool, nchunks: int) -> np.ndarray:
    """uint64 [chunks, m]: bit s of chunk c = (w >= thr of substream 64c + s),
    0 past the row and on self-loops, as the kernel's two ballots per edge."""
    width = thr.shape[1]
    s = np.arange(CHUNK * nchunks)
    if packed:
        k, j = s // 8, s % 8
        ok = k < width
        t = np.where(ok, thr[j, np.minimum(k, width - 1)], 0)
    else:
        ok = s < width
        t = np.where(ok, thr[0, np.minimum(s, width - 1)], 0)
    bits = (w[:, None] >= t[None]) & ok[None] & (u != v)[:, None]
    return np.packbits(bits, axis=1, bitorder="little").view("<u8").T.copy()


def _latest(u, v, x, start, stop):
    """(edge, side) of the latest edge in [start, stop) that touched x, or None."""
    for h in range(stop - 1, start - 1, -1):
        if v[h] == x:
            return h, 1
        if u[h] == x:
            return h, 0
    return None


def _walk(u, v, te, mem):
    """One walker over one column chunk: returns add [m]; ``mem`` (uint64
    [rows]) is updated in place by the batch write-backs. Each batch runs
    the kernel's rounds (every edge recomputed from its in-batch touchers'
    current post-values until nothing changes), held here to the sequential
    pass and to the bound of depth + 2 rounds."""
    m = u.shape[0]
    nb = -(-m // B)
    add = np.zeros(m, U64)
    post = np.zeros((m, 2), U64)
    loaded = {}
    for j in range(-D, nb):
        # the rows of batch j + D are loaded before batch j's chain
        for i in range((j + D) * B, min((j + D + 1) * B, m)):
            loaded[i] = (mem[u[i]], mem[v[i]])
        if j < 0:
            continue
        lo, first, end = max(0, (j - D) * B), j * B, min((j + 1) * B, m)
        n = end - first
        # base rows: the previous batches' post-values, or the loaded rows
        base = np.zeros((n, 2), U64)
        link = [[None, None] for _ in range(n)]
        depth = np.zeros(n, int)
        for l in range(n):
            i = first + l
            for side, x in enumerate((u[i], v[i])):
                before = _latest(u, v, x, lo, first)
                base[l, side] = loaded[i][side] if before is None else post[before]
                within = _latest(u, v, x, first, i)
                if within is not None:
                    link[l][side] = (within[0] - first, within[1])
                    depth[l] = max(depth[l], depth[within[0] - first] + 1)
        # the rounds
        cur = base.copy()
        for rounds in range(1, B + 2):
            r = np.array([[base[l, s] if link[l][s] is None else cur[link[l][s]]
                           for s in (0, 1)] for l in range(n)], U64).reshape(n, 2)
            t = te[first:end]
            new = np.stack([r[:, 0] | (t & ~r[:, 1]), r[:, 1] | (t & ~r[:, 0])], axis=1)
            changed = (new != cur).any()
            cur = new
            if all(x is None for pair in link for x in pair) or not changed:
                break
        assert rounds <= (depth.max(initial=0) + 2 if n else 1)
        # the same batch one edge after another
        seq = base.copy()
        for l in range(n):
            ru, rv = (base[l, s] if link[l][s] is None else seq[link[l][s]] for s in (0, 1))
            seq[l] = (ru | (te[first + l] & ~rv), rv | (te[first + l] & ~ru))
        np.testing.assert_array_equal(cur, seq)
        post[first:end] = cur
        add[first:end] = te[first:end] & ~(r[:, 0] | r[:, 1])
        # write-back: each vertex once, from its last touch, when the batch changed it
        last = {}
        for i in range(first, end):
            last[u[i]] = (i, 0)
            last[v[i]] = (i, 1)
        for x, (i, side) in last.items():
            assert mem[x] == base[i - first, side], "a row written back must replace the batch's start"
            if post[i, side] != base[i - first, side]:
                mem[x] = post[i, side]
    return add


def window_model(edges, weights, thresholds, n_pad, mb_init=None, packed=True):
    """The kernel's schedule in numpy on the wrapper's operands; returns
    (assigned int32 [m], block [n_pad, width]) as numpy."""
    e = edges.numpy()
    u, v, w = e[:, 0], e[:, 1], weights.numpy()
    thr = thresholds.numpy()
    width = thr.shape[1]
    nchunks = kernel.edge_chunks(width, packed)
    init = (np.zeros((n_pad, width), np.uint8 if packed else np.int8) if mb_init is None
            else mb_init.numpy())
    mem = _words(init, packed, nchunks)
    te = _eligibility(w, u, v, thr, packed, nchunks)
    assigned = np.full(u.shape[0], -1, np.int32)
    for c in range(nchunks):
        add = _walk(u, v, te[c], mem[c])
        hi = np.array([int(a).bit_length() - 1 for a in add], np.int32)
        assigned = np.maximum(assigned, np.where(hi >= 0, CHUNK * c + hi, -1))
    return assigned, _block(mem, packed, width)


def _case(name):
    """(case, carried bits?, packed width cut to or None) by name: a
    WINDOW stream takes ``-L<L>``, ``-mb0`` and ``-w2`` modifiers."""
    if name.startswith("zoo_"):
        return ZOO[name[4:]](), False, None
    if name == "rmat8":
        return rmat_case(8, edge_factor=8, L=16, pad=3), False, None
    if name == "rmat10":
        return rmat_case(10, edge_factor=4, L=64), False, None
    base, *mods = name.split("-")
    L = next((int(x[1:]) for x in mods if x.startswith("L")), 64)
    raw = 2 if "w2" in mods else None
    return WINDOW[base](L), "mb0" in mods, raw


CASES = ([f"zoo_{k}" for k in ZOO] + ["rmat8", "rmat10"] + sorted(WINDOW)
         + [f"{s}-L{L}" for s in ("hub", "repeat_d33", "self_loops_mid") for L in (13, 65, 300, 2048)]
         + ["hub-mb0", "hub-L300-mb0", "hub-L2048-mb0", "repeat_d64-mb0", "m33-mb0"])
PACKED_ONLY = ["hub-L13-w2", "m31-L13-w2-mb0"]


@functools.lru_cache(maxsize=None)
def _operands(name, packed):
    """The per-edge kernel's operands for a case on the CPU. Carried bits
    come from the oracle run over a second stream on the same vertices."""
    c, carried, raw = _case(name)
    stream = EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad, device="cpu")
    cfg = SubstreamConfig(n=c.n, L=c.L, eps=c.eps)
    edges, w, thr, n_pad, _ = kernel_inputs(stream, cfg, packed=packed)
    if raw is not None:
        thr = thr[:, :raw].contiguous()
    mb0 = None
    if carried:
        rng = np.random.default_rng(len(name))
        pre = torch.from_numpy(rng.integers(0, c.n, (3 * c.n + 8, 2)).astype(np.int32))
        pre_w = torch.from_numpy(rng.uniform(1, float(c.w.max(initial=2.0)), pre.shape[0])
                                 .astype(np.float32))
        _, mb0 = _oracle(pre, pre_w, thr, n_pad, None, packed)
        mb0 = torch.from_numpy(mb0.copy())
        if not packed:  # a carried non-zero byte is a set bit, whatever its value
            mb0 = mb0 * torch.from_numpy(rng.integers(1, 100, mb0.shape).astype(np.int8))
    return edges, w, thr, n_pad, mb0


def _oracle(edges, w, thr, n_pad, mb0, packed):
    """The JAX package's pure oracle on the operands (numpy out)."""
    e = jnp.asarray(edges.numpy())
    if packed:
        a, mb = jref_packed(e[:, 0], e[:, 1], jnp.asarray(w.numpy()),
                            jnp.asarray(thr.numpy().T.reshape(-1)), n_pad,
                            mb0=None if mb0 is None else jnp.asarray(mb0.numpy()))
    else:
        a, mb = jref(e[:, 0], e[:, 1], jnp.asarray(w.numpy()), jnp.asarray(thr.numpy()[0]),
                     n_pad, mb0=None if mb0 is None else jnp.asarray(mb0.numpy()))
    return np.asarray(a), np.asarray(mb)


@functools.lru_cache(maxsize=None)
def _want(name, packed):
    """The oracle's result; its unpacked block keeps carried byte values,
    which the kernels' contract reads as set bits (0/1)."""
    a, mb = _oracle(*_operands(name, packed), packed)
    return a, mb if packed else (mb != 0).astype(np.int8)


PARAMS = [(c, p) for c in CASES for p in (True, False)] + [(c, True) for c in PACKED_ONLY]
IDS = [f"{c}-{'packed' if p else 'unpacked'}" for c, p in PARAMS]


@pytest.mark.parametrize("name, packed", PARAMS, ids=IDS)
def test_window_model_matches_oracle(name, packed):
    got_a, got_mb = window_model(*_operands(name, packed), packed=packed)
    want_a, want_mb = _want(name, packed)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)


@pytest.mark.parametrize("name, packed", PARAMS, ids=IDS)
def test_plain_version_matches_oracle(name, packed):
    plain = kernel.substream_match_packed_plain if packed else kernel.substream_match_unpacked_plain
    got_a, got_mb = plain(*_operands(name, packed))
    want_a, want_mb = _want(name, packed)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_mb.numpy(), want_mb)


def test_window_cases_reach_the_window():
    """The aimed streams do what they are named for: at L = 64 the window
    forwards (an edge finds an earlier toucher in its own or the previous
    batch) and the streams straddle batch bounds."""
    for name in ("hub", "repeat_d31", "repeat_d33", "repeat_d63", "self_loops_mid"):
        c = WINDOW[name]()
        forwarded = 0
        for i in range(c.src.shape[0]):
            lo = max(0, (i // B - D) * B)
            window = set(c.src[lo:i]) | set(c.dst[lo:i])
            forwarded += int(c.src[i] in window or c.dst[i] in window)
        assert forwarded > c.src.shape[0] // 4, name
        assert c.src.shape[0] > 2 * B
    assert [WINDOW[f"m{m}"]().src.shape[0] for m in (0, 1, 31, 32, 33)] == [0, 1, 31, 32, 33]


def test_schedule_constants_match_the_source():
    """kernel.py's constants are the CUDA source's compile-time constants."""
    src = kernel.EDGES_SOURCE.read_text()
    want = {"kBatch": kernel.EDGE_BATCH, "kPrefetch": kernel.EDGE_PREFETCH,
            "kChunkBits": kernel.EDGE_CHUNK_BITS, "kStageEdges": kernel.EDGE_STAGE_EDGES}
    for name, value in want.items():
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(value)], name
    assert pathlib.Path(kernel.EDGES_SOURCE).name == "substream_match_edges.cu"
    for entry in (kernel.NAME, kernel.UNPACKED_NAME):
        assert f'extern "C" int {entry}(' in src


@pytest.mark.parametrize("width, packed, chunks", [(0, True, 1), (2, True, 1), (8, True, 1),
                                                   (9, True, 2), (256, True, 32),
                                                   (16, False, 1), (64, False, 1),
                                                   (80, False, 2), (2048, False, 32)])
def test_edge_chunks(width, packed, chunks):
    assert kernel.edge_chunks(width, packed) == chunks
