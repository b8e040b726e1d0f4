"""The rounds engine of ``csrc/substream_match_edges.cu`` modelled in numpy.

:func:`rounds_model` follows the engine's schedule on the packed per-edge
kernel's operands with the constants of ``kernel.py``: slices and chunks
from :func:`~repro_torch.kernels.substream_match.kernel.rounds_geometry`,
one stable sort of the int32 keys ``chunk << vbits | vertex`` per slice,
each chunk's incidences in tiles of ``EDGE_ROUNDS_THREADS *
EDGE_ROUNDS_ITEMS`` positions (one CTA each), and the chunk's rounds: the
kill, the segmented exclusive OR-scan (inside each tile, then the
look-back over the tiles' aggregates), the winners from the side-0
incidence of each edge, and the two ways a chunk ends. It asserts on the
way what the engine relies on: the tiles' scan with its look-back carry is
the chunk's scan, and the winners at one vertex hold disjoint bits.

It imports numpy and the port only, so the CPU tests hold it to the JAX
package's oracles and the card tests hold the CUDA engine to it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.substream_match import kernel

U64 = np.uint64
TILE = kernel.EDGE_ROUNDS_THREADS * kernel.EDGE_ROUNDS_ITEMS


def eligibility(w: np.ndarray, u: np.ndarray, v: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """uint64 [m]: bit s = (w >= threshold of substream s), for the 8 * width
    substreams of bit planes ``thr`` [8, width] (s = 8k + j is thr[j, k]),
    0 on self-loops."""
    width = thr.shape[1]
    s = np.arange(8 * width)
    t = thr[s % 8, s // 8]
    bits = (w[:, None] >= t[None]) & (u != v)[:, None]
    out = np.zeros(w.shape[0], U64)
    for k in range(8 * width):
        out |= bits[:, k].astype(U64) << U64(k)
    return out


def seg_inclusive_or(val: np.ndarray, head: np.ndarray):
    """Inclusive segmented OR-scan (a head starts a segment) by doubling
    steps; returns (the scan, whether a head lies at or before each
    position)."""
    v, h = val.copy(), head.copy()
    d = 1
    while d < v.shape[0]:
        pv = np.concatenate([np.zeros(d, U64), v[:-d]])
        ph = np.concatenate([np.zeros(d, bool), h[:-d]])
        v = np.where(h, v, v | pv)
        h = h | ph
        d *= 2
    return v, h


def seg_exclusive_or(val: np.ndarray, head: np.ndarray) -> np.ndarray:
    """Exclusive segmented OR-scan: each position's OR of the earlier
    positions of its segment."""
    inc, _ = seg_inclusive_or(val, head)
    out = np.concatenate([np.zeros(1, U64), inc[:-1]])
    return np.where(head, U64(0), out)


def tiled_scan(val: np.ndarray, head: np.ndarray, tile: int = TILE) -> np.ndarray:
    """The engine's scan of one chunk: each tile's own exclusive scan, its
    aggregate (whether it holds a head; the OR from its last head to its end,
    or of all of it), the look-back (the OR of the tiles before, back to the
    first with a head) added to the positions before the tile's first head."""
    n = val.shape[0]
    if n == 0:
        return val.copy()
    pos = np.arange(n)
    start = pos // tile * tile
    restart = head | (pos == start)
    local_inc, _ = seg_inclusive_or(val, restart)
    local = np.where(restart, U64(0), np.concatenate([np.zeros(1, U64), local_inc[:-1]]))
    tiles = -(-n // tile)
    has_head = np.logical_or.reduceat(head, np.arange(0, n, tile))
    agg = local_inc[np.minimum((np.arange(tiles) + 1) * tile, n) - 1]
    carry = np.zeros(tiles, U64)
    for b in range(1, tiles):
        for j in range(b - 1, -1, -1):
            carry[b] |= agg[j]
            if has_head[j]:
                break
    lead = np.maximum.accumulate(np.where(head, pos, -1)) < start
    return np.where(lead, local | carry[pos // tile], local)


def rounds_model(edges, weights, thresholds, n_pad: int, mb_init=None, geometry=None,
                 tile: int = TILE):
    """The engine on the wrapper's operands (torch tensors on the CPU, or
    numpy); returns (assigned int32 [m], mb uint8 [n_pad, width], chunks,
    rounds). ``geometry`` replaces :func:`kernel.rounds_geometry`'s
    (chunk, slice, vbits) and ``tile`` the CTA's incidences, to reach
    chunk and tile bounds on short streams."""
    e = np.asarray(edges)
    u, v = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
    w = np.asarray(weights)
    thr = np.asarray(thresholds)
    width = thr.shape[1]
    assert width <= kernel.ROUNDS_MAX_WIDTH
    m = u.shape[0]
    block = np.zeros((n_pad, 8), np.uint8)
    if mb_init is not None:
        block[:, :width] = np.asarray(mb_init)
    mem = block.view("<u8")[:, 0].copy()
    te = eligibility(w, u, v, thr)
    assigned = np.full(m, -1, np.int32)
    chunks = rounds = 0
    if m:
        chunk, slice_edges, vbits = geometry or kernel.rounds_geometry(m, n_pad)
        vmask = (1 << vbits) - 1
        for lo in range(0, m, slice_edges):
            n = min(m, lo + slice_edges) - lo
            flat = e[lo:lo + n].reshape(-1).astype(np.int64)
            keys = ((np.arange(2 * n) >> 1) // chunk << vbits) | flat
            assert keys.max(initial=0) < 2**31
            perm = np.argsort(keys, kind="stable")
            skeys = keys[perm]
            for e0 in range(0, n, chunk):
                ce = min(chunk, n - e0)
                j = perm[2 * e0:2 * (e0 + ce)] - 2 * e0
                ck = skeys[2 * e0:2 * (e0 + ce)]
                el, side1 = j >> 1, (j & 1).astype(bool)
                x = ck & vmask
                g = lo + e0 + el  # the stream's edge
                y = np.where(side1, u[g], v[g])
                assert np.array_equal(x, np.where(side1, v[g], u[g]))
                head = np.concatenate([[True], ck[1:] != ck[:-1]])
                val = np.where(x != y, te[g], U64(0))
                chunks += 1
                first = True
                while True:
                    # A: the kill, then the scan
                    val = val & ~(mem[x] | mem[y])
                    live = bool(val.any())
                    bits = tiled_scan(val, head, tile)
                    assert np.array_equal(bits, seg_exclusive_or(val, head))
                    bv = np.zeros(ce, U64)
                    bv[el[side1]] = bits[side1]
                    if not live and not first:
                        break
                    rounds += live
                    # B: the winners, from each edge's side-0 incidence
                    s0 = ~side1
                    win = val[s0] & ~bits[s0] & ~bv[el[s0]]
                    at = np.concatenate([x[s0], y[s0]])
                    both = np.concatenate([win, win])
                    hit = both != 0
                    ored = np.zeros(n_pad, U64)
                    np.bitwise_or.at(ored, at[hit], both[hit])
                    bitsum = np.zeros(n_pad, np.int64)
                    np.add.at(bitsum, at[hit], _popcount(both[hit]))
                    assert np.array_equal(bitsum, _popcount(ored)), "winners at a vertex overlap"
                    mem |= ored
                    top = top_bit(win)
                    ge = g[s0]
                    assigned[ge] = top if first else np.maximum(assigned[ge], top)
                    rest = bool((val[s0] & ~win).any())
                    first = False
                    if not rest:
                        break
    out = mem.copy().view(np.uint8).reshape(n_pad, 8)[:, :width].copy()
    return assigned, out, chunks, rounds


def top_bit(x: np.ndarray) -> np.ndarray:
    """int32: the highest set bit of each uint64, -1 for 0."""
    top = np.zeros(x.shape, np.int32)
    y = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        big = (y >> U64(s)) != 0
        top += big.astype(np.int32) * s
        y = np.where(big, y >> U64(s), y)
    return np.where(x != 0, top, -1).astype(np.int32)


def _popcount(x: np.ndarray) -> np.ndarray:
    b = x.view(np.uint8).reshape(-1, 8)
    return np.unpackbits(b, axis=1).sum(axis=1).astype(np.int64)
