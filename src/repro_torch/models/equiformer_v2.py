"""Equiformer-v2-style equivariant graph attention (arXiv:2306.12059).

eSCN trick (arXiv:2302.03655): rotate each edge's irrep features into the
edge-aligned frame, where the SO(3) tensor-product convolution becomes
block-diagonal in m — SO(2) 2x2 blocks — and truncate to |m| <= m_max.
This turns the O(l_max^6) CG contraction into O(l_max^3) work.

Fidelity note (the reference's): the azimuthal part of the edge alignment
(rotation about z by -phi) is implemented *exactly* — it is block-diagonal
cos/sin(m*phi) on real spherical harmonics. The polar (Wigner-d) part is
replaced by a learned per-(l, m) radial modulation; this keeps the eSCN
compute pattern (per-edge, per-m SO(2) block matmuls over channels,
attention in the invariant channel) but trades exact SO(3) equivariance of
the full layer for z-rotation equivariance.

Features: X [N, (l_max+1)^2, C] real-SH irreps; attention: scalar (l=0)
channel -> per-head logits -> edge softmax -> weighted message sum.
Assigned: n_layers=12, d_hidden=128, l_max=6, m_max=2, heads=8. The JAX
package's ``repro.models.equiformer_v2``; what differs:

* the reference's ``.at[:, idx, :].set`` writes are one out-of-place
  ``index_copy`` into zeros (autograd holds), and its ``.at[d].max`` from
  -inf a ``scatter_reduce(..., "amax", include_self=True)``;
* each chunk's two passes run under ``torch.utils.checkpoint``
  (``use_reentrant=False``) as the reference's run under ``jax.checkpoint``,
  but pass 2's segment sums over the destinations are taken outside it (a
  segment sum saves only its ids, and the backward pass then recomputes
  no [N, n_coef, C] sum); the chunks' sums are added as they come (a
  running sum saves nothing under autograd) where the reference stacks
  them;
* ``src_blocked`` reads ``X[s]``'s own rows: chunk i gathers from node block
  [i * Nb, min((i + 1) * Nb, N)). The reference slices the block with
  ``dynamic_slice_in_dim``, which clamps its start to N - Nb, but indexes it
  from the unclamped start, so when N is not a multiple of the number of
  chunks its last chunk reads other rows (ROADMAP.md §3);
* on a mesh (edges split over some mesh dimensions) chunk i is the i-th
  part of each rank's edges (``gnn_common.edge_chunks``: no edge moves),
  so a sharded batch keeps the ``src_blocked`` contract rank by rank: the
  i-th part of every rank's edges has its sources in node block i. Each
  rank gathers that block alone, and each chunk's partial sums are reduced
  onto the nodes' layout at once, as the reference constrains them; pass
  1's max over the ranks sends its gradient only to the edges at the
  global max.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import constrain, on_mesh, row_layout, use_mesh, zeros
from repro_torch.models.gnn_common import (
    GraphBatch,
    edge_chunks,
    masked_mse,
    mlp_apply,
    mlp_specs,
    segment_sum,
)
from repro_torch.models.param import ArraySpec, build_params


@dataclasses.dataclass(frozen=True)
class EqV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 16
    d_out: int = 1
    n_radial: int = 16
    edge_chunk: int = 0
    # src-blocked message passing: the data pipeline sorts edges by source
    # block and each chunk i only reads node block i — the paper's
    # BRAM-epoch/blocking pattern (§4.2) applied to equivariant message
    # passing, bounding each chunk's gather working set to one node block.
    src_blocked: bool = False
    dtype: Any = torch.float32

    @property
    def n_coef(self) -> int:
        return (self.l_max + 1) ** 2


def _lm_tables(l_max: int):
    """flat coefficient index -> (l, m); real-SH ordering m = -l..l."""
    ls, ms = [], []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            ls.append(l)
            ms.append(m)
    return np.asarray(ls), np.asarray(ms)


def _zrot_tables(cfg: EqV2Config):
    """(ls, ms, pair): pair[i] is the index of (l, -m) for i = (l, m)."""
    ls, ms = _lm_tables(cfg.l_max)
    pos_of = {(l, m): idx for idx, (l, m) in enumerate(zip(ls, ms))}
    pair = np.asarray([pos_of[(l, -m)] for l, m in zip(ls, ms)])
    return ls, ms, pair


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)``'s float32 formula: start * (1 - t)
    + stop * t with t = iota / (num - 1), then stop (XLA's CPU division
    leaves some of its values one ulp away)."""
    div = num - 1
    t = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(start) * (np.float32(1) - t) + np.float32(stop) * t
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32)


def param_specs(cfg: EqV2Config):
    C, H = cfg.d_hidden, cfg.n_heads
    n_m = cfg.m_max + 1
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(
            {
                # SO(2) conv weights: per retained m, [l-pairs folded into C]
                # realized as per-m channel-mixing matrices (eSCN style).
                "so2_w": ArraySpec((n_m, 2 * C, 2 * C), (None, None, None), cfg.dtype),
                "so2_w0": ArraySpec((C, C), (None, None), cfg.dtype),
                "radial": mlp_specs((cfg.n_radial, C, n_m * 2), cfg.dtype),
                "attn": mlp_specs((C, C, H), cfg.dtype),
                "val_mix": ArraySpec((H, C, C), (None, None, None), cfg.dtype),
                "gate": mlp_specs((C, C, (cfg.l_max + 1) * C), cfg.dtype),
                "ffn_w1": ArraySpec((C, 2 * C), (None, None), cfg.dtype),
                "ffn_w2": ArraySpec((2 * C, C), (None, None), cfg.dtype),
                "ln_scale": ArraySpec((C,), (None,), cfg.dtype, "ones"),
            }
        )
    return {
        "embed_scalar": mlp_specs((cfg.d_in, cfg.d_hidden), cfg.dtype),
        "layers": layers,
        "head": mlp_specs((cfg.d_hidden, cfg.d_hidden, cfg.d_out), cfg.dtype),
    }


class _Tables:
    """The static index tables of one forward, on its device."""

    def __init__(self, cfg: EqV2Config, device):
        ls, ms, pair = _zrot_tables(cfg)
        as_long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        self.ls = as_long(ls)
        self.pair = as_long(pair)
        self.abs_m = torch.as_tensor(np.abs(ms), dtype=cfg.dtype, device=device)
        self.msign = torch.as_tensor(np.sign(ms), dtype=cfg.dtype, device=device)[None, :, None]
        self.is0 = torch.as_tensor(ms == 0, device=device)[None, :, None]
        # the SO(2) blocks: m = 0, then (m, -m) for m = 1..m_max, each in ascending l
        self.idx0 = as_long(np.nonzero(ms == 0)[0])
        self.idx_pm = [(as_long(np.nonzero(ms == m)[0]), as_long(np.nonzero(ms == -m)[0]))
                       for m in range(1, cfg.m_max + 1)]
        self.written = torch.cat([self.idx0] + [i for pm in self.idx_pm for i in pm])
        self.mu = torch.as_tensor(_linspace(0.0, 6.0, cfg.n_radial), device=device)


def _equiv_layernorm(X, scale, eps=1e-5):
    """Norm over each l's vector length (equivariant); scale on channels."""
    norm = torch.sqrt((X * X).mean(dim=(1, 2), keepdim=True) + eps)
    return X / norm * scale[None, None, :]


def _radial_basis(dist, mu, n_radial, r_max=6.0):
    beta = (n_radial / r_max) ** 2
    return torch.exp(-beta * (dist[:, None] - mu[None, :]) ** 2)


def _zrot(X, phi, t: _Tables, inverse=False):
    """Exact real-SH rotation about z by angle phi (per edge).

    X: [E, n_coef, C]; phi: [E]. Components (l, m), (l, -m) mix with
    cos(m phi) / sin(m phi).
    """
    sgn = -1.0 if inverse else 1.0
    ang = sgn * phi[:, None] * t.abs_m[None, :]  # [E, n_coef]
    c = torch.cos(ang)[..., None]
    s = torch.sin(ang)[..., None]
    Xp = X.index_select(1, t.pair)  # partner component (l, -m)
    return torch.where(t.is0, X, c * X + t.msign * s * Xp)


def _sub(w: dict, prefix: str) -> dict:
    """The entries of the flat parameter dict ``w`` under ``prefix``."""
    return {k[len(prefix) + 1:]: v for k, v in w.items() if k.startswith(prefix + ".")}


def _layer(lp, X, batch: GraphBatch, cfg: EqV2Config, t: _Tables):
    N, n_coef, C = X.shape
    E = batch.e
    chunk = cfg.edge_chunk or E
    assert E % chunk == 0
    nc = E // chunk
    Nb = -(-N // nc)  # src-block size (src_blocked mode)
    if cfg.src_blocked and (nc - 1) * Nb >= N:
        raise ValueError(f"src_blocked: {nc} chunks leave the last node block of "
                         f"{N} nodes (blocks of {Nb}) empty")
    sharded = isinstance(batch.src, DTensor)
    chunks = list(zip(range(nc), edge_chunks(batch.src, nc), edge_chunks(batch.dst, nc),
                      edge_chunks(batch.edge_mask, nc)))
    names, wv = zip(*lp.named_parameters())

    def msg_chunk(X, x0, coords, w, i, s, d_):
        """Chunk i's messages and logits; ``X`` holds the node rows from
        ``x0`` on (all of them, or, on a mesh, node block i)."""
        rel = coords.index_select(0, d_) - coords.index_select(0, s)  # [c, 3]
        dist = torch.linalg.vector_norm(rel, dim=-1) + 1e-9
        phi = torch.atan2(rel[:, 1], rel[:, 0])
        rb = _radial_basis(dist, t.mu, cfg.n_radial)  # [c, R]
        rmod = mlp_apply(_sub(w, "radial"), rb)  # [c, 2*n_m]
        rows = s
        if cfg.src_blocked:
            # chunk i's sources live in node block i (pipeline contract):
            # gather from that block only, at X[s]'s own rows
            lo = i * Nb
            rows = s.clamp(lo, min(lo + Nb, N) - 1)
        Xs = X.index_select(0, rows - x0 if x0 else rows)  # [c, n_coef, C]
        Xs = constrain(Xs, "edges", None, None)
        Xr = _zrot(Xs, phi, t)  # align azimuth (exact)
        # eSCN SO(2) conv: m=0 block real matmul; m>0: stacked (m, -m) 2C vec
        X0 = Xr.index_select(1, t.idx0)  # [c, l_max+1, C]
        parts = [torch.einsum("clk,kj->clj", X0, w["so2_w0"]) * rmod[:, None, 0:1]]
        for m, (idx_p, idx_n) in enumerate(t.idx_pm, start=1):
            v = torch.cat([Xr.index_select(1, idx_p), Xr.index_select(1, idx_n)], dim=-1)
            y = torch.einsum("cld,de->cle", v, w["so2_w"][m]) * rmod[:, None, 2 * m : 2 * m + 1]
            parts.extend(torch.split(y, C, dim=-1))
        # components with |m| > m_max stay zero (the eSCN m-truncation)
        out = Xr.new_zeros(Xr.shape).index_copy(1, t.written, torch.cat(parts, dim=1))
        # attention logits from invariant channel
        logits = mlp_apply(_sub(w, "attn"), out[:, 0, :])  # [c, H]
        out = _zrot(out, phi, t, inverse=True)
        return out, logits

    # Both passes take X and the max as arguments: a checkpointed function
    # runs again in the backward pass, after this layer has rebound X.
    # pass 1: per-chunk edge max for a numerically stable edge softmax,
    # maxed over the chunks (the gradient flows through it, as in JAX)
    def pass1(X, x0, coords, i, s, d_, mk, *wv):
        _, logits = msg_chunk(X, x0, coords, dict(zip(names, wv)), i, s, d_)
        logits = torch.where(mk[:, None], logits, -torch.inf)
        init = logits.new_full((N, cfg.n_heads), -torch.inf)
        idx = d_.long()[:, None].expand(-1, cfg.n_heads)
        mx = init.scatter_reduce(0, idx, logits, "amax", include_self=True)
        if not sharded:
            return mx
        with torch.no_grad():  # this rank's edges at its max
            count = torch.zeros_like(mx).scatter_add_(
                0, idx, (logits == mx.gather(0, idx)).to(mx.dtype))
        return _EdgeMax.apply(mx, count, batch.src.device_mesh, _split_dims(batch.src))

    # pass 2: each edge's weight and weighted value; their sums over the
    # destinations are taken outside the checkpoint (a segment sum saves
    # only its ids), so the backward pass recomputes no [N, ...] sum
    def pass2(X, x0, mx, coords, i, s, d_, mk, *wv):
        out, logits = msg_chunk(X, x0, coords, dict(zip(names, wv)), i, s, d_)
        w = torch.exp(logits - mx.index_select(0, d_))  # [c, H]
        w = torch.where(mk[:, None], w, 0.0)
        # value mixing per head, then weight
        vh = torch.einsum("cnk,hkj->cnhj", out, dict(zip(names, wv))["val_mix"])  # [c, n_coef, H, C]
        return (vh * w[:, None, :, None]).sum(dim=2), w  # [c, n_coef, C], [c, H]

    coords = batch.coords
    if sharded:  # each rank's edges against node block i (or all nodes)
        block = (lambda i: (i * Nb, min(i * Nb + Nb, N))) if cfg.src_blocked else None
        p1, p2 = _edge_local(batch.src, pass1, pass2, len(wv), block)
    else:
        p1 = lambda X, *rest: pass1(X, 0, *rest)
        p2 = lambda X, *rest: pass2(X, 0, *rest)
    # each chunk's max laid out on the nodes (the max over the chunks saves
    # its stacked input for the backward pass)
    mx = torch.stack([constrain(checkpoint(p1, X, coords, *c, *wv, use_reentrant=False),
                                "nodes", None) for c in chunks]).amax(0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    acc = z = None
    for c in chunks:
        vw, w = checkpoint(p2, X, mx, coords, *c, *wv, use_reentrant=False)
        d_ = c[2]
        # each chunk's sums laid out on the nodes at once, as the reference
        # constrains them
        acc_p = _node_sums(vw, d_, N, cfg.l_max + 1)
        z_p = constrain(segment_sum(w, d_, N), "nodes", None)
        acc, z = (acc_p, z_p) if acc is None else (acc + acc_p, z + z_p)
    agg = acc / torch.clamp(z.sum(-1), min=1e-9)[:, None, None]
    X = X + agg
    # gated nonlinearity: scalars gate each l block
    gates = torch.sigmoid(mlp_apply(lp.gate, X[:, 0, :]))  # [N, (l_max+1)*C]
    gates = _per_coefficient(gates.reshape(N, cfg.l_max + 1, C), t.ls)
    ff = F.silu(X[:, 0, :] @ lp.ffn_w1) @ lp.ffn_w2
    X = X * gates
    X = torch.cat([X[:, :1, :] + ff[:, None, :], X[:, 1:, :]], dim=1)
    X = _equiv_layernorm(X, lp.ln_scale)
    return constrain(torch.where(batch.node_mask[:, None, None], X, 0), "nodes", None, None)


def _per_coefficient(g, ls):
    """``g [N, l_max+1, C]`` spread to each coefficient's l: ``g[:, ls]``; on
    a DTensor split over the nodes, on each rank's rows (its backward, an
    ``index_add``, has no DTensor rule on every torch)."""
    if not isinstance(g, DTensor):
        return g.index_select(1, ls)
    place = row_layout(g)
    return local_map(lambda gl: gl.index_select(1, ls), out_placements=place,
                     in_placements=(place,), device_mesh=g.device_mesh)(g)


def _node_sums(vw, dst, n: int, groups: int):
    """``segment_sum(vw, dst, n)`` [n, n_coef, C] laid out on the nodes.
    On a mesh each rank's sum over its own edges is a whole [n, ...] block
    before it is reduced onto the nodes: there it is taken ``groups``
    slices of the coefficients at a time (the whole block is 61 GB at
    ogb_products), and the slices joined on each rank's rows."""
    if not isinstance(vw, DTensor):
        return constrain(segment_sum(vw, dst, n), "nodes", None, None)
    step = -(-vw.shape[1] // groups)
    return torch.cat([constrain(segment_sum(vw[:, j:j + step], dst, n), "nodes", None, None)
                      for j in range(0, vw.shape[1], step)], dim=1)


def _split_dims(t: DTensor) -> list:
    """The mesh dimensions that split ``t``'s rows."""
    return [d for d, p in enumerate(row_layout(t)) if p.is_shard()]


class _EdgeMax(torch.autograd.Function):
    """Per node and head, the max over the ranks of each rank's edge max
    ``mx`` (``count`` of its edges at it), over the mesh dimensions ``dims``.
    The gradient goes to the ranks that hold the max, each its share of the
    edges at it (its ``count`` over their sum): spread evenly over a rank's
    edges by the local max's backward, every tied edge of the chunk gets an
    equal part, as jax splits the gradient of a scatter max."""

    @staticmethod
    def forward(ctx, mx, count, mesh, dims):
        from torch.distributed import _functional_collectives as funcol

        def across(x, op):
            for d in dims:
                x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, d)))
            return x

        top = across(mx, "max")
        mine = torch.where(mx == top, count, 0.0)
        ctx.save_for_backward(mine / across(mine, "sum").clamp(min=1.0))
        return top

    @staticmethod
    def backward(ctx, g):
        (share,) = ctx.saved_tensors
        return g * share, None, None, None


def _node_block(X: DTensor, lo: int, hi: int) -> DTensor:
    """Rows [lo, hi) of the node tensor ``X`` (rows split over some mesh
    dimensions, or whole), replicated: each rank puts its own rows of the
    block in place in zeros, and the partial blocks are summed (never more
    than the block is gathered). The gradient goes back to each rank's rows."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, place = X.device_mesh, row_layout(X)
    (n, *_), (off, *_) = compute_local_shape_and_global_offset(X.shape, mesh, place)
    a, b = max(lo, off), min(hi, off + n)

    def body(xl):
        mine = xl[a - off:b - off] if a < b else xl[:0]
        before = a - lo if a < b else hi - lo
        return F.pad(mine, (0, 0) * (xl.dim() - 1) + (before, hi - lo - before - mine.shape[0]))

    part = local_map(body, out_placements=[Partial() if p.is_shard() else Replicate()
                                           for p in place],
                     in_placements=(place,), device_mesh=mesh)(X)
    return part.redistribute(mesh, [Replicate()] * mesh.ndim)


def _edge_local(src, pass1, pass2, n_w: int, block):
    """The two passes over DTensors: on each rank's edges through
    ``local_map``, against node block i (``block(i)``: its rows; None: all
    the nodes) gathered inside them, with the max and the coordinates whole
    (a checkpointed pass saves the split X, not the gathered rows). Pass 1's
    max is reduced across the ranks inside it (:class:`_EdgeMax`); pass 2's
    per-edge weights and values stay on each rank's edges."""
    mesh, place = src.device_mesh, row_layout(src)
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in place]

    def local(fn):
        def run(*args):
            with use_mesh(None):  # the bodies' constraints place nothing
                return fn(*args)
        return run

    edge_in = (None, place, place, place)  # i, s, d, mask
    p1 = local_map(local(pass1), out_placements=whole,
                   in_placements=(whole, None, whole, *edge_in, *[whole] * n_w),
                   in_grad_placements=(grad, None, grad, *edge_in, *[grad] * n_w),
                   device_mesh=mesh)
    p2 = local_map(local(pass2), out_placements=(place, place),
                   in_placements=(whole, None, whole, whole, *edge_in, *[whole] * n_w),
                   in_grad_placements=(grad, None, grad, grad, *edge_in, *[grad] * n_w),
                   device_mesh=mesh)
    gather = lambda t: on_mesh(t, mesh).redistribute(mesh, whole)

    def rows(X, i):
        if block is None:
            return gather(X), 0
        lo, hi = block(i)
        return _node_block(on_mesh(X, mesh), lo, hi), lo

    def pass1_sharded(X, coords, i, *rest):
        return p1(*rows(X, i), gather(coords), i, *rest)

    def pass2_sharded(X, mx, coords, i, *rest):
        return p2(*rows(X, i), gather(mx), gather(coords), i, *rest)

    return pass1_sharded, pass2_sharded


class EquiformerV2(nn.Module):
    """Equiformer-v2 on ``device`` (None: the CUDA card), initialized from ``seed``."""

    def __init__(self, cfg: EqV2Config, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        build_params(self, param_specs(cfg), resolve_device(device), seed)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        cfg = self.cfg
        t = _Tables(cfg, batch.node_feats.device)
        h0 = mlp_apply(self.embed_scalar, batch.node_feats.to(cfg.dtype))
        X = torch.cat([h0[:, None, :], zeros((batch.n, cfg.n_coef - 1, cfg.d_hidden), h0.dtype,
                                             h0.device, "nodes", None, None)], dim=1)
        X = torch.where(batch.node_mask[:, None, None], X, 0)
        for lp in self.layers:
            X = _layer(lp, X, batch, cfg, t)
        return mlp_apply(self.head, X[:, 0, :])

    def loss_fn(self, batch: GraphBatch) -> torch.Tensor:
        return masked_mse(self(batch), batch, self.cfg.d_out)


MODEL = EquiformerV2
