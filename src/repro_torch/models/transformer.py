"""Decoder-only transformer LM family (dense GQA + MoE variants).

Covers internlm2-20b, minicpm-2b, gemma-7b (dense) and
moonshot-v1-16b-a3b, grok-1-314b (MoE); the JAX package's
``repro.models.transformer``. :class:`Transformer` holds the parameters,
declared as the reference's tree of :class:`ArraySpec` with the layers
**stacked** (one ``[n_layers, ...]`` parameter per leaf, ``layers.wq``
and so on, indexed per layer in a Python loop), so its ``state_dict`` keys
are the reference's leaves. The functions take the module where the
reference takes its parameter tree: :func:`backbone`, :func:`loss_fn`,
:func:`prefill` and :func:`decode_step`.

Precision follows the reference at every point. Operands of different
dtypes are promoted as ``jnp`` promotes them: gemma's embedding scale is a
numpy float64 scalar, which makes its residual stream, projections and
attention float32 over bfloat16 weights (the weights are promoted for each
product); the other archs stay in their ``param_dtype``. The reference's
``preferred_element_type=jnp.float32`` products (attention scores and
outputs) take their operands as they are and return float32: a float32
product on the card (:func:`_matmul_f32`), on the CPU the operands promoted
to float32 first (a bfloat16 product is exact in float32 either way). The
softmax runs in float32, ``p`` is cast to v's dtype, and the output is cast
back to q's dtype. Run with TF32 off (PyTorch's default for matmuls).

Three departures from the reference's schedule, none in the values:

* :func:`attention` over a sequence that its chunk does not divide runs a
  short last chunk (the reference runs one chunk over all of S: at 32,769
  tokens a 68.7 GB block of scores); a query row's softmax does not depend
  on the chunking;
* :func:`prefill` returns the k/v that each layer computed (the reference
  computes them again after the layer) into a cache of ``max_len`` slots
  allocated once;
* :func:`decode_step` scores the cache and the new token's own slot
  separately and takes one softmax over both (the reference concatenates
  the slot onto the cache, a copy of the cache in every layer).

One departure in the draws: the head-major attention projections are
drawn at their true fan-in (the reference's default fan-in, ``shape[-2]``,
is the head count there, which makes the attention scores of a published
width ~190 wide and a deep model chaotic; ROADMAP.md §3). Parity tests
carry the reference's weights across, so no computation differs.

Under sharding rules (every parameter a DTensor on a mesh, the logical
names of the production meshes; ``launch/steps.py::arch_rules``) the
layouts are pinned where the reference's constraints and XLA's choices put
them: the residual stream split as ``("dp", "model_seq", "model_d")``; the
projections' inputs gathered whole and each weight's FSDP-split rows
gathered, so q/k/v land on their heads (or, for replicated heads, on the
sequence) and each model-axis partial sum is reduce-scattered back onto
the stream; attention on each rank's (batch, head, query block) through
``local_map``; products of a DTensor and a 2-d weight on each rank's shards
(:func:`_sharded_matmul`); the MoE routing and combine on each rank's
groups; the loss a vocabulary-parallel cross entropy; decode attention
combined across the cache's split slots. The values are the unsharded
ones (float32 sums in another order).

Where autograd records (a training step), each layer, each attention
query step and each loss chunk runs under ``torch.utils.checkpoint`` when
``remat`` is set, as the reference's ``jax.checkpoint`` does, and the
softmax, the causal mask and the GLU product work out of place. Under
``torch.no_grad`` (prefill and decode) nothing is checkpointed and those
three work in place, which is what keeps a 32K prefill's score blocks and
FFN hidden within one card. ``unroll`` is accepted and changes nothing:
the layer and chunk loops are Python loops. A stacked leaf's gradient is
written layer by layer into one buffer (:class:`_LayerSlice`), not summed
from a leaf-sized tensor per layer.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import (constrain, on_mesh, pin_grad, replicated_like,
                                              zeros)
from repro_torch.models.embedding import take_rows
from repro_torch.models.param import ArraySpec, build_params


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"  # swiglu | geglu | gelu
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"  # "ep" | "tp"
    moe_groups: int = 1  # dispatch groups (= DP shards in production)
    # EPxTP folding: each expert's FFN dim split into `expert_fold` slices
    # stored as separate "half-experts" (grok: 8e x2).
    expert_fold: int = 1
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    vocab_pad_to: int = 256
    param_dtype: Any = torch.bfloat16
    attn_chunk: int = 512
    attn_par: int = 1  # chunks batched per attention product (see attention())
    loss_chunk: int = 512
    logit_softcap: float = 0.0
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    remat: bool = True  # checkpoint layers, query steps, loss chunks (training)
    unroll: bool = False  # accepted; the port's loops are Python loops
    # GQA kv heads expanded to full heads before attention (train/prefill)
    expand_kv: bool = False

    @property
    def vocab_padded(self) -> int:
        v, p = self.vocab, self.vocab_pad_to
        return ((v + p - 1) // p) * p

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def ff_mult(self) -> int:
        return 2 if self.act in ("swiglu", "geglu") else 1

    def param_count(self) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv * self.d_head * 2
        if self.is_moe:
            ffn = self.n_experts * (d * f * self.ff_mult + f * d) + d * self.n_experts
        else:
            ffn = d * f * self.ff_mult + f * d
        return L * (attn + ffn + 2 * d) + 2 * self.vocab_padded * d + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv * self.d_head * 2
        ffn = self.top_k * (d * f * self.ff_mult + f * d) + d * self.n_experts
        return L * (attn + ffn + 2 * d) + 2 * self.vocab_padded * d + d


# ---------------------------------------------------------------- params


def param_specs(cfg: TransformerConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    L, H, Kv, Dh = cfg.n_layers, cfg.n_heads, cfg.n_kv, cfg.d_head

    # the head-major projections are drawn at their true fan-in (d for wq,
    # wk, wv; H * Dh for wo): the reference's default, shape[-2], is the
    # head count (or head width) there (ROADMAP.md §3)
    layer: dict[str, ArraySpec] = {
        "ln1": ArraySpec((L, d), ("layers", None), dt, "ones"),
        "ln2": ArraySpec((L, d), ("layers", None), dt, "ones"),
        "wq": ArraySpec((L, d, H, Dh), ("layers", "embed", "heads", None), dt,
                        scale=1.0 / math.sqrt(d)),
        "wk": ArraySpec((L, d, Kv, Dh), ("layers", "embed", "kv_heads", None), dt,
                        scale=1.0 / math.sqrt(d)),
        "wv": ArraySpec((L, d, Kv, Dh), ("layers", "embed", "kv_heads", None), dt,
                        scale=1.0 / math.sqrt(d)),
        "wo": ArraySpec((L, H, Dh, d), ("layers", "heads", None, "embed"), dt,
                        scale=1.0 / math.sqrt(H * Dh)),
    }
    if cfg.is_moe:
        Fo = cfg.expert_fold
        assert cfg.d_ff % Fo == 0 and (cfg.d_ff * cfg.ff_mult) % Fo == 0
        layer |= {
            "router": ArraySpec((L, d, cfg.n_experts), ("layers", "embed", None), torch.float32),
            "w1": ArraySpec(
                (L, cfg.n_experts * Fo, d, cfg.d_ff * cfg.ff_mult // Fo),
                ("layers", "expert", "embed", "expert_mlp"),
                dt,
            ),
            "w2": ArraySpec(
                (L, cfg.n_experts * Fo, cfg.d_ff // Fo, d),
                ("layers", "expert", "expert_mlp", "embed"),
                dt,
            ),
        }
    else:
        layer |= {
            "w1": ArraySpec((L, d, cfg.d_ff * cfg.ff_mult), ("layers", "embed", "mlp"), dt),
            "w2": ArraySpec((L, cfg.d_ff, d), ("layers", "mlp", "embed"), dt),
        }
    return {
        "embed": ArraySpec((cfg.vocab_padded, d), ("vocab", "embed"), dt, "embed", 1.0),
        "layers": layer,
        "ln_f": ArraySpec((d,), (None,), dt, "ones"),
        "lm_head": ArraySpec((d, cfg.vocab_padded), ("embed", "vocab"), dt),
    }


def rope_freqs(d_head: int, theta: float) -> torch.Tensor:
    """float32 [d_head // 2]: ``exp(-arange(half) * log(theta) / half)`` on
    the host. Its lanes may differ by an ulp from the reference's (XLA's
    ``exp``), so parity tests carry the reference's vector across
    (``convert.params_from_reference(..., buffers=...)``)."""
    half = d_head // 2
    return torch.exp(-torch.arange(half, dtype=torch.float32) * (math.log(theta) / half))


class Transformer(nn.Module):
    """The LM's parameters (the reference's tree, layers stacked) and its
    RoPE frequency buffer ``rope_freqs``, on ``device`` (None: the CUDA
    card), drawn from ``seed`` on the CPU, or from ``generator`` (a seeded
    ``torch.Generator("cuda")`` draws on the card)."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        build_params(self, param_specs(cfg), dev, seed, generator)
        self.register_buffer("rope_freqs", rope_freqs(cfg.d_head, cfg.rope_theta).to(dev))

    def layer_params(self, i: int) -> dict:
        """Layer ``i``'s slice of every stacked leaf (:class:`_LayerSlice`)."""
        names, leaves = zip(*self.layers.named_parameters())
        return dict(zip(names, _LayerSlice.apply(i, *leaves)))


class _LayerSlice(torch.autograd.Function):
    """Row ``i`` of each stacked leaf. Its backward adds each row's gradient
    into row ``i`` of the leaf's ``.grad`` (zeros, allocated once): autograd's
    select-backward would build a zero tensor of the whole leaf for every
    layer and sum them, ~3 passes over the leaves per layer (2.4 % of a
    minicpm-2b train step, PERF.md §6). The values are those sums' (a row's
    gradient plus zeros)."""

    @staticmethod
    def forward(ctx, i, *leaves):
        ctx.i, ctx.leaves = i, leaves
        return tuple(p[i] for p in leaves)

    @staticmethod
    def backward(ctx, *grads):
        for p, g in zip(ctx.leaves, grads):
            if g is not None:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad[ctx.i] += g
        return (None,) * (1 + len(grads))


# ---------------------------------------------------------------- layers


def _promote(*xs):
    """The operands in their common dtype (jnp's promotion: bf16 with f32 is f32)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def _matmul(a, b):
    """``a @ b`` in the operands' common dtype (``jnp.einsum`` / ``@``); a
    DTensor ``a`` times a 2-d ``b`` through :func:`_sharded_matmul`."""
    a, b = _promote(a, b)
    if isinstance(a, DTensor) and b.dim() == 2:
        return _sharded_matmul(a, b)
    return torch.matmul(a, b)


def _sharded_matmul(a: DTensor, b) -> DTensor:
    """``a [..., K] @ b [K, N]`` with each rank multiplying its own shards
    (``local_map``), ``b`` laid out to match ``a`` on each mesh dimension:
    where ``a``'s rows are split, ``b`` is whole and the result's rows split
    (``b``'s gradient a partial sum there); where ``a``'s K is split (or
    ``a`` is whole and ``b``'s rows split: ``a`` is cut to match), ``b``'s
    rows are split alike and the result is a partial sum; where ``a`` is
    whole, ``b`` keeps its split columns (the result's columns split,
    ``a``'s gradient a partial sum) or is whole. DTensor's own product
    searches its strategies and redistributions at every call, which on a
    3-d mesh with two split leading dimensions took minutes a layer."""
    mesh = a.device_mesh
    b = on_mesh(b, mesh)
    last = a.dim() - 1
    # a partial ``a`` is reduced; a whole ``a`` against ``b``'s split rows is
    # cut along K (locally) to match them
    want = [Replicate() if pa.is_partial() else
            Shard(last) if pa.is_replicate() and pb.is_shard(0) else pa
            for pa, pb in zip(a.placements, b.placements)]
    if want != list(a.placements):
        a = a.redistribute(mesh, want)
    a_place = list(a.placements)
    b_place, out, a_grad, b_grad = [], [], [], []
    for pa, pb in zip(a_place, b.placements):
        if pa.is_shard(last):
            b_place.append(Shard(0)), out.append(Partial()), a_grad.append(pa)
            b_grad.append(Shard(0))
        elif pa.is_shard():
            b_place.append(Replicate()), out.append(pa), a_grad.append(pa)
            b_grad.append(Partial())
        elif pb.is_shard(1):
            b_place.append(pb), out.append(Shard(last)), a_grad.append(Partial())
            b_grad.append(pb)
        else:
            b_place.append(Replicate()), out.append(Replicate()), a_grad.append(Replicate())
            b_grad.append(Replicate())
    b = b.redistribute(mesh, b_place)
    return local_map(torch.matmul, out_placements=out, in_placements=(a_place, b_place),
                     in_grad_placements=(a_grad, b_grad), device_mesh=mesh)(a, b)


def _recording(*xs) -> bool:
    """Whether autograd records an op on ``xs`` (a training step)."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _bmm_f32(a, b):
    """cuBLAS's bf16 GEMM with float32 output over operands of equal batch shape."""
    batch = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*batch, *out.shape[-2:])


class _MatmulF32(torch.autograd.Function):
    """:func:`_bmm_f32` where autograd records (its ``out_dtype`` form has no
    derivative): each operand's gradient is a GEMM of the float32 cotangent
    rounded to the operands' dtype, in that dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.matmul(g, b.mT), torch.matmul(a.mT, g)


def _matmul_f32(a, b):
    """``a @ b`` with ``preferred_element_type=float32``: the operands in their
    common dtype, float32 products and sums, a float32 result. Batched
    operands of equal batch shape; a bfloat16 product on the card is cuBLAS's
    bf16 GEMM with float32 output, elsewhere the operands are promoted to
    float32 (the products are exact either way)."""
    a, b = _promote(a, b)
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return _MatmulF32.apply(a, b) if _recording(a, b) else _bmm_f32(a, b)
    return torch.matmul(a.float(), b.float())


def _softmax_(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(s, -1)`` in place: exp(s - max) / sum."""
    s.sub_(s.amax(-1, keepdim=True)).exp_()
    return s.div_(s.sum(-1, keepdim=True))


class _CausalSoftmax(torch.autograd.Function):
    """``softmax(where(ok, s * scale, -1e30))`` over the last axis, on a new
    tensor (the same operations as the in-place path, so the same values),
    saving only the probabilities ``p``. Backward: ``scale * p * (g - sum(g *
    p))``, the reference's softmax jvp transposed; a masked entry's ``p`` is
    0, so its gradient is too. ``s`` [B, Hk, G*n, S]; ``ok`` [n, S]."""

    @staticmethod
    def forward(ctx, s, ok, scale, G):
        B, Hk, _, S = s.shape
        p = s.mul(scale)
        p.view(B, Hk, G, -1, S).masked_fill_(~ok, -1e30)
        ctx.scale = scale
        p = _softmax_(p)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        gs = g * p
        gs.addcmul_(p, gs.sum(-1, keepdim=True), value=-1.0)
        return gs.mul_(ctx.scale), None, None, None


def rmsnorm(x, scale, eps):
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * scale


def rope(x, positions, freqs):
    """x: [..., S, H, D]; positions broadcastable [..., S]; freqs float32 [D/2]."""
    half = x.shape[-1] // 2
    ang = replicated_like(positions[..., None].float() * freqs, x)  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _glu(g, u, act):
    """The gate ``g`` activated times the up half ``u``."""
    gate = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
    return gate * u if _recording(gate, u) else gate.mul_(u)


def _activate(h, act):
    """GLU gates (the gate half times the up half) or gelu; jax's ``gelu``
    is the tanh approximation."""
    if act in ("swiglu", "geglu"):
        return _glu(*torch.chunk(h, 2, dim=-1), act)
    return F.gelu(h, approximate="tanh")


def _up(x, w, act, hidden, w_names):
    """``_activate(x @ w, act)``; ``w_names`` and ``hidden`` name the logical
    axes of ``w`` (laid out so first) and of the result. Where the GLU's two
    halves of ``w``'s columns are split over the mesh, each half is
    multiplied apart (the weight's half gathered and split again): the
    product's halves would otherwise be regathered, an activation-sized
    all-gather, where this moves a weight's."""
    w = constrain(w, *w_names)
    if act in ("swiglu", "geglu") and isinstance(w, DTensor) and any(
            p.is_shard(w.dim() - 1) for p in w.placements):
        f = w.shape[-1] // 2
        wg, wu = (constrain(w[..., sl], *w_names) for sl in (slice(0, f), slice(f, None)))
        return _glu(constrain(_matmul(x, wg), *hidden), constrain(_matmul(x, wu), *hidden), act)
    return _activate(constrain(_matmul(x, w), *hidden), act)


def _attend(q, kT, vh, qpos, G: int):
    """Query rows ``q`` [B, n, Hq, D] at positions ``qpos`` [n] against the
    keys ``kT`` [B, Hk, D, S] and values ``vh`` [B, Hk, S, D] at or before
    them -> [B, n, Hq, D] in q's dtype."""
    B, n, Hq, D = q.shape
    Hk, S = kT.shape[1], kT.shape[3]
    qh = q.reshape(B, n, Hk, G, D).permute(0, 2, 3, 1, 4).reshape(B, Hk, G * n, D)
    s = _matmul_f32(qh, kT)  # [B, Hk, G*n, S]
    ok = qpos[:, None] >= torch.arange(S, device=q.device)[None, :]  # causal [n, S]
    scale = 1.0 / np.sqrt(D)
    if _recording(s):
        p = _CausalSoftmax.apply(s, ok, scale, G)
    else:
        s.mul_(scale).view(B, Hk, G, n, S).masked_fill_(~ok, -1e30)
        p = _softmax_(s)
    p = p.to(vh.dtype)
    o = _matmul_f32(p, vh)  # [B, Hk, G*n, D]
    return o.reshape(B, Hk, G, n, D).permute(0, 3, 1, 2, 4).reshape(B, n, Hq, D).to(q.dtype)


def attention(q, k, v, cfg: TransformerConfig, q0: int = 0):
    """Query-chunked causal attention; no [S, S] tensor.

    q: [B, Sq, Hq, D] (query rows at positions ``q0 + j``), k/v: [B, S, Hk,
    D] with Hq = Hk * G. The reference's schedule: chunks of ``attn_chunk``
    queries, ``attn_par`` of them batched into one product (chunk ``p *
    n_outer + i`` in step i), the steps in a loop; each step's [B, Hk, G,
    par * c, S] float32 block of scores is the only attention transient.
    Where ``attn_chunk`` does not divide Sq the remainder runs as one short
    last chunk (see the module docstring). Where autograd records and
    ``cfg.remat`` is set, each step is checkpointed (the reference's
    per-step ``jax.checkpoint``).
    """
    if isinstance(q, DTensor):
        return _attention_sharded(q, k, v, cfg)
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    c = min(cfg.attn_chunk, S)
    nq = S // c
    par = max(1, min(cfg.attn_par, nq))
    while nq % par:
        par -= 1
    n_outer = nq // par
    kT = k.permute(0, 2, 3, 1).contiguous()  # [B, Hk, D, S]
    vh = v.permute(0, 2, 1, 3).contiguous()  # [B, Hk, S, D]
    out = torch.empty_like(q)
    dev = q.device
    main = q[:, : nq * c].reshape(B, par, n_outer, c, Hq, D)
    rows = (torch.arange(par, device=dev)[:, None] * n_outer) * c + torch.arange(c, device=dev)
    if cfg.remat and _recording(q, k, v):
        step = lambda *args: checkpoint(_attend, *args, use_reentrant=False)
    else:
        step = _attend
    for i in range(n_outer):
        qpos = (rows + i * c).reshape(-1)  # [par * c]
        qi = main[:, :, i].reshape(B, par * c, Hq, D)
        out[:, qpos] = step(qi, kT, vh, qpos + q0, G)
    if S % c:  # ragged tail: one short chunk
        qpos = torch.arange(nq * c, S, device=dev)
        out[:, nq * c:] = step(q[:, nq * c:], kT, vh, qpos + q0, G)
    return out


def _attention_sharded(q, k, v, cfg: TransformerConfig):
    """:func:`attention` of DTensor operands, run on each rank's shard of
    them through ``local_map``: attention is local to a (sequence, head)
    pair of the batch, so where q, k and v split the batch and the heads
    (evenly, alike), each rank's shard is a whole attention problem and the
    plain code runs on it unchanged (no communication; the values are the
    unsharded ones). The batched products would otherwise flatten two
    sharded batch dimensions, which DTensor refuses. Where q also splits
    its sequence (the sequence-parallel attention of replicated-head archs,
    each rank a contiguous block of query rows), k and v are gathered whole
    along the sequence (the reference's constraints on them) and each rank
    attends its block, the reference's ``attn_par`` chunks shared out over
    those mesh dimensions. Raises ``ValueError`` for any other layout (a
    split head width, partial sums, uneven shards)."""
    mesh, place = q.device_mesh, tuple(q.placements)
    if not all(p.is_replicate() or (p.is_shard() and p.dim in (0, 1, 2)) for p in place):
        raise ValueError(f"attention: placements {place}; only the batch, sequence and heads split")
    kv_place = tuple(Replicate() if p.is_shard(1) else p for p in place)
    if tuple(k.placements) != place and tuple(k.placements) != kv_place:
        raise ValueError(f"attention: q placed {place}, k {tuple(k.placements)}")
    if tuple(v.placements) != tuple(k.placements):
        raise ValueError(f"attention: k placed {tuple(k.placements)}, v {tuple(v.placements)}")
    k, v = (t.redistribute(mesh, kv_place) for t in (k, v))
    heads = math.prod(mesh.size(d) for d, p in enumerate(place) if p.is_shard(2))
    if q.shape[2] % heads or k.shape[2] % heads:
        raise ValueError(f"attention: {q.shape[2]} and {k.shape[2]} heads over {heads} shards")
    seq = [d for d, p in enumerate(place) if p.is_shard(1)]
    n_seq = math.prod(mesh.size(d) for d in seq)
    if q.shape[1] % n_seq:
        raise ValueError(f"attention: {q.shape[1]} positions over {n_seq} shards")
    index = 0  # this rank's block of query rows, the mesh dimensions major to minor
    for d in seq:
        index = index * mesh.size(d) + mesh.get_local_rank(d)
    local_cfg = dataclasses.replace(cfg, attn_par=max(1, cfg.attn_par // n_seq))
    fn = functools.partial(attention, cfg=local_cfg, q0=index * (q.shape[1] // n_seq))
    layout, kv_layout = list(place), list(kv_place)  # lists: a tuple reads as one per output
    # each block of queries reads k and v whole: their gradients are partial
    # sums over the mesh dimensions that split the queries
    kv_grad = [Partial() if p.is_shard(1) else kp for p, kp in zip(place, kv_place)]
    local = local_map(fn, out_placements=layout, in_placements=(layout, kv_layout, kv_layout),
                      in_grad_placements=(layout, kv_grad, kv_grad), device_mesh=mesh)
    return local(q, k, v)


def _moe_dispatch(xg, router_w, cfg: TransformerConfig):
    """Route the groups' tokens xg [G, Tl, d] -> (buf [G, E, C, d] in
    ``param_dtype``, slot and keep [G, Tl*k], gate_f [G, Tl*k]): each
    (token, choice) pair takes the next free slot of its expert in token
    order (a one-hot cumsum), the pairs past capacity C dropped into an
    overflow row E * C. Local to each group."""
    G, Tl, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(Tl * k * cfg.capacity_factor / E))
    C = ((C + 7) // 8) * 8
    logits = torch.matmul(xg.float(), router_w)  # [G, Tl, E]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: among equal probabilities the lower expert first
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = ranked[..., :k], order[..., :k]  # [G, Tl, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    eid_f = eid.reshape(G, Tl * k)
    gate_f = gate.reshape(G, Tl * k)
    oh = F.one_hot(eid_f, E)  # [G, Tl*k, E]
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1  # position within expert
    keep = pos < C
    slot = torch.where(keep, eid_f * C + torch.clamp(pos, 0, C - 1), E * C)
    xt = xg.repeat_interleave(k, dim=1)  # [G, Tl*k, d]: token t's k rows
    xt = torch.where(keep[..., None], xt, 0)
    disp = xt.new_zeros(G, E * C + 1, d)
    disp.scatter_(1, slot[..., None].expand(-1, -1, d), xt)  # one pair per slot
    return disp[:, : E * C].reshape(G, E, C, d).to(cfg.param_dtype), slot, keep, gate_f


def _moe_combine(out_buf, slot, keep, gate_f, cfg: TransformerConfig):
    """The experts' outputs out_buf [G, E*F, C, d] back to the tokens ->
    [G, Tl, d]: the folds' partial outputs summed, then each token's k
    weighted outputs added in choice order, in the outputs' dtype (the
    reference's ``segment_sum`` on the CPU). Local to each group."""
    G, EF, C, d = out_buf.shape
    E, k, Fo = cfg.n_experts, cfg.top_k, cfg.expert_fold
    if Fo > 1:  # block-diagonal FFN decomposition: sum fold partials
        out_buf = out_buf.reshape(G, E, Fo, C, d).sum(2)
    out_flat = out_buf.reshape(G, E * C, d)
    picked = torch.gather(
        out_flat, 1, torch.clamp(slot, 0, E * C - 1)[..., None].expand(-1, -1, d))
    picked = torch.where(keep[..., None], picked, 0)
    contrib = (picked * gate_f[..., None].to(picked.dtype)).reshape(G, slot.shape[1] // k, k, d)
    combined = contrib[:, :, 0]
    for j in range(1, k):
        combined = combined + contrib[:, :, j]
    return combined


def _moe_ffn(x, router_w, w1, w2, cfg: TransformerConfig, batch: str = "dp"):
    """x: [T, d] -> [T, d]. Group-local capacity dispatch, as the reference:
    tokens split into ``moe_groups`` groups (the logical axis ``batch``),
    routed by :func:`_moe_dispatch`, ``expert_fold`` copies of each expert's
    tokens for the folded experts, the experts' FFNs as one product batched
    over the experts (``expert`` split: EP; ``expert_mlp`` split: TP), and
    :func:`_moe_combine`. Under rules the routing and the combine run on
    each rank's groups (``local_map``), the buffer is cut to the rank's
    experts, and the experts' outputs are gathered whole before the
    combine (the reference's constraints)."""
    T, d = x.shape
    G = max(1, min(cfg.moe_groups, T))
    assert T % G == 0, (T, G)
    xg = constrain(x.reshape(G, T // G, d), batch, None, None)
    if isinstance(xg, DTensor):
        router_w = constrain(router_w, None, None)
        group_place = list(xg.placements)
        dispatch = functools.partial(_moe_dispatch, cfg=cfg)
        buf, slot, keep, gate_f = local_map(
            dispatch, out_placements=(group_place,) * 4,
            in_placements=(group_place, [Replicate()] * xg.device_mesh.ndim),
            in_grad_placements=(group_place, [Partial() if p.is_shard() else Replicate()
                                              for p in group_place]),
            device_mesh=xg.device_mesh)(xg, router_w)
        w2 = constrain(w2, "expert", "expert_mlp", None)
    else:
        buf, slot, keep, gate_f = _moe_dispatch(xg, router_w, cfg)
    C = buf.shape[2]
    Fo = cfg.expert_fold
    if Fo > 1:  # every fold of an expert sees the same tokens
        buf = buf.repeat_interleave(Fo, dim=1)  # [G, E*F, C, d]
    buf = constrain(buf, batch, "expert", None, None)
    EF = buf.shape[1]
    be = buf.permute(1, 0, 2, 3).reshape(EF, G * C, d)  # experts lead: one batched product
    h = _up(be, w1, cfg.act, ("expert", batch, "expert_mlp"),
            ("expert", None, "expert_mlp"))  # [E*F, G*C, f]
    out = constrain(_matmul(h, w2), "expert", batch, None)
    out_buf = out.reshape(EF, G, C, d).permute(1, 0, 2, 3)  # [G, E*F, C, d]
    if isinstance(out_buf, DTensor):
        # the combine gathers from a group-local buffer, whole over the experts
        out_buf = constrain(out_buf, batch, None, None, None)
        combine = functools.partial(_moe_combine, cfg=cfg)
        group_place = list(out_buf.placements)
        combined = local_map(combine, out_placements=group_place,
                             in_placements=[group_place] * 4,
                             device_mesh=out_buf.device_mesh)(out_buf, slot, keep, gate_f)
    else:
        combined = _moe_combine(out_buf, slot, keep, gate_f, cfg)
    combined = constrain(combined, batch, None, None)
    return combined.reshape(T, d).to(x.dtype)


def _qkv(h, lp, cfg: TransformerConfig, positions, freqs, lead=("dp", "model_seq")):
    """q, k, v [B, S, heads, D] of h [B, S, d] (``lead``: the logical names of
    its batch and sequence dimensions). Under rules each projection lands
    on the attention layout: the heads (sharded-head archs) or the sequence
    (replicated-head archs, sequence-parallel): h's features are gathered
    and each weight's FSDP-split rows, so the product splits only the
    batch, the sequence and the heads, and never an uneven head count."""
    B, S, d = h.shape
    hf = constrain(h, *lead, None)

    def proj(w, heads):
        if isinstance(w, DTensor):
            y = _matmul(hf, pin_grad(constrain(w, None, heads, None).reshape(d, -1)))
        else:
            y = _matmul(h.reshape(B * S, d), w.reshape(d, -1))
        return constrain(y.reshape(B, S, w.shape[1], w.shape[2]), *lead, heads, None)

    q = rope(proj(lp["wq"], "heads"), positions, freqs)
    kk = rope(proj(lp["wk"], "kv_heads"), positions, freqs)
    return q, kk, proj(lp["wv"], "kv_heads")


#: the logical layout of the residual stream between and within layers
_BOUNDARY = ("dp", "model_seq", "model_d")
#: a decode step's: the batch, one position, the features
_DECODE = ("cache_batch", None, "model_d")


def _out_proj(attn, wo):
    """einsum("bshk,hkd->bsd", attn, wo)."""
    B, S, H, Dh = attn.shape
    return _matmul(pin_grad(attn.reshape(B, S, H * Dh)), pin_grad(wo.reshape(H * Dh, -1)))


def _ffn(h2, lp, cfg: TransformerConfig, lead=("dp", "model_seq")):
    """The FFN of h2 [B, S, d] (``lead``: the logical names of its batch and
    sequence dimensions). Under rules a dense FFN gathers h2's features and
    splits its hidden units over ``mlp``; its output is a partial sum."""
    B, S, d = h2.shape
    if cfg.is_moe:
        h2 = constrain(h2, *lead, None)
        return _moe_ffn(h2.reshape(B * S, d), lp["router"], lp["w1"], lp["w2"], cfg,
                        lead[0]).reshape(B, S, d)
    hid = _up(constrain(h2, *lead, None), lp["w1"], cfg.act, (*lead, "mlp"), (None, "mlp"))
    return _matmul(hid, lp["w2"])


def _layer(x, lp, cfg: TransformerConfig, positions, freqs):
    """One block; returns (x, k, v), k/v as ``_qkv`` gave them."""
    G = cfg.n_heads // cfg.n_kv
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, kk, vv = _qkv(h, lp, cfg, positions, freqs)
    ka, va = kk, vv
    if cfg.expand_kv and G > 1:
        # [B, S, H, D], split over the heads as q is (a replicated k/v is
        # cut locally)
        ka = constrain(kk.repeat_interleave(G, dim=2), "dp", "model_seq", "heads", None)
        va = constrain(vv.repeat_interleave(G, dim=2), "dp", "model_seq", "heads", None)
    attn = attention(q, ka, va, cfg)
    del q, ka, va
    # each partial sum over the model axis is reduce-scattered onto the
    # layer boundary's layout
    x = x + constrain(_out_proj(attn, lp["wo"]), *_BOUNDARY).to(x.dtype)
    del attn
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + constrain(_ffn(h2, lp, cfg), *_BOUNDARY).to(x.dtype), kk, vv


def embed_rows(table, tokens, cfg: TransformerConfig):
    """Embedding rows of ``tokens``; gemma's scale is a numpy float64, which
    promotes the stream to float32 as in the reference. Under rules the
    table's FSDP-sharded feature dimension is gathered, not the rows read."""
    x = take_rows(constrain(table, "vocab", None), tokens)
    if cfg.embed_scale:
        x = x.float() * float(np.sqrt(cfg.d_model))
    return x


def _embed(model: Transformer, tokens):
    return embed_rows(model.embed, tokens, model.cfg)


def _layer_out(x, lp, cfg: TransformerConfig, positions, freqs):
    return _layer(x, lp, cfg, positions, freqs)[0]


def _run_layers(model: Transformer, x, positions, cfg: TransformerConfig, cache=None):
    """Every layer in order, each checkpointed where autograd records and
    ``cfg.remat`` is set; with ``cache``, layer i's k/v are written into
    ``cache["k"][i, :, :S]`` (in the cache's dtype)."""
    S = x.shape[1]
    for i in range(cfg.n_layers):
        lp = model.layer_params(i)
        if cfg.remat and _recording(x, *lp.values()):
            x = checkpoint(_layer_out, x, lp, cfg, positions, model.rope_freqs,
                           use_reentrant=False)
        else:
            x, kk, vv = _layer(x, lp, cfg, positions, model.rope_freqs)
            if cache is not None:
                for c, new in ((cache["k"][i], kk), (cache["v"][i], vv)):
                    if isinstance(c, DTensor):  # the whole layer: placed as its cache
                        c.copy_(new.to(c.dtype).redistribute(c.device_mesh, c.placements))
                    else:
                        c[:, :S] = new
            del kk, vv
        x = constrain(x, *_BOUNDARY)
    return x


def backbone(model: Transformer, tokens, cfg: Optional[TransformerConfig] = None):
    """tokens [B, S] -> final hidden [B, S, d]. Differentiable: the softmax,
    mask and GLU product work out of place where autograd records, and the
    layers and attention steps are checkpointed under ``cfg.remat``; under
    ``torch.no_grad()`` (a server) they work in place and nothing is kept."""
    cfg = cfg or model.cfg
    S = tokens.shape[1]
    tokens = constrain(tokens, "dp", None)
    x = constrain(_embed(model, tokens), *_BOUNDARY)
    positions = torch.arange(S, device=x.device)[None, :]
    x = _run_layers(model, x, positions, cfg)
    return rmsnorm(x, model.ln_f, cfg.norm_eps)


class _ShardNLL(torch.autograd.Function):
    """Each row's ``logsumexp - gold`` of logits whose last axis is split in
    blocks over ``group`` (this rank's block starts at column ``start``):
    the max, the sum of exponentials and the gold logit are reduced across
    the blocks, one value a row (a vocabulary-parallel cross entropy). The
    backward, ``g * (softmax - onehot(gold))``, needs no communication."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        from torch.distributed import _functional_collectives as funcol

        def across(t, op):
            return t if group is None else funcol.all_reduce(t, op, group)

        V = logits.shape[-1]
        m = across(logits.amax(-1, keepdim=True), "max")
        e = torch.exp(logits - m)
        se = across(e.sum(-1, keepdim=True), "sum")
        idx = labels.long()[..., None] - start
        mine = (idx >= 0) & (idx < V)
        idx = idx.clamp(0, V - 1)
        gold = across(torch.where(mine, torch.gather(logits, -1, idx), 0.0), "sum")
        ctx.save_for_backward(e.div_(se), mine, idx)
        return (m + torch.log(se) - gold)[..., 0]

    @staticmethod
    def backward(ctx, g):
        p, mine, idx = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, idx, -(g[..., None] * mine))
        return grad, None, None, None


def _sharded_nll(logits, labels):
    """:class:`_ShardNLL` of a DTensor ``logits`` [B, c, V] whose vocabulary
    is split over at most one mesh dimension (its rows split as the labels'
    [B, c]), run on each rank's shard through ``local_map``; the result is
    placed as ``labels``."""
    mesh, place = logits.device_mesh, tuple(logits.placements)
    vocab = [d for d, p in enumerate(place) if p.is_shard(logits.dim() - 1)]
    if len(vocab) > 1:
        raise ValueError(f"loss: the vocabulary split over mesh dimensions {vocab}")
    rows = [Replicate() if p.is_shard(logits.dim() - 1) or p.is_partial() else p for p in place]
    if any(p.is_partial() for p in place) or tuple(labels.placements) != tuple(rows):
        raise ValueError(f"loss: logits placed {place}, labels {tuple(labels.placements)}")
    start, group = 0, None
    if vocab:
        block = logits.to_local().shape[-1]
        if block * mesh.size(vocab[0]) != logits.shape[-1]:
            raise ValueError(f"loss: {logits.shape[-1]} columns unevenly over {mesh.size(vocab[0])}")
        start = mesh.get_local_rank(vocab[0]) * block
        group = mesh.get_group(vocab[0])
    return local_map(lambda lg, lb: _ShardNLL.apply(lg, lb, start, group), out_placements=rows,
                     in_placements=(list(place), rows), device_mesh=mesh)(logits, labels)


def _chunk_nll(lm_head, h, labels, mask, cfg: TransformerConfig):
    """The summed next-token NLL of one chunk of positions: float32 logits
    (soft-capped), ``logsumexp - gold`` where ``mask``."""
    logits = _matmul(h, lm_head).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    # on a DTensor, a vocabulary-parallel cross entropy: DTensor's own
    # gather would build the chunk's whole [B, c, V] gradient on every rank
    if isinstance(logits, DTensor):
        nll = _sharded_nll(logits, labels)
    else:
        nll = (torch.logsumexp(logits, -1, keepdim=True)
               - torch.gather(logits, -1, labels[..., None].long()))[..., 0]
    return torch.where(mask, nll, 0.0).sum()


def lm_loss(lm_head, h, tokens, cfg: TransformerConfig):
    """The next-token loss of the final hidden rows ``h`` [B, S, d] of
    ``tokens`` [B, S]: the labels are the tokens shifted left with the
    first moved to the end, the last position masked out; the head runs in
    chunks of ``loss_chunk`` positions (each checkpointed where autograd
    records and ``cfg.remat`` is set: one [B, loss_chunk, V] float32 block
    of logits at a time); the chunks' sum over the unmasked count. Under
    rules the rows are gathered whole and the head's FSDP-sharded rows too,
    so each chunk's logits split only the batch and the vocabulary."""
    B, S = tokens.shape
    c = min(cfg.loss_chunk, S)
    if S % c:
        raise ValueError(f"loss_chunk {c} does not divide the sequence length {S}")
    h = constrain(h, "dp", None, None)
    lm_head = constrain(lm_head, None, "vocab")
    tokens = constrain(tokens, "dp", None)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(B, S, dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    mask = constrain(mask, "dp", None)
    remat = cfg.remat and _recording(h, lm_head)
    nlls = []
    for j in range(0, S, c):
        args = (lm_head, h[:, j:j + c], labels[:, j:j + c], mask[:, j:j + c], cfg)
        nlls.append(checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
                    else _chunk_nll(*args))
    return torch.stack(nlls).sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(model: Transformer, tokens, cfg: Optional[TransformerConfig] = None):
    """Next-token cross entropy of ``tokens`` [B, S] (the reference's
    ``loss_fn``): :func:`backbone`, then :func:`lm_loss`."""
    cfg = cfg or model.cfg
    c = min(cfg.loss_chunk, tokens.shape[1])
    if tokens.shape[1] % c:
        raise ValueError(f"loss_chunk {c} does not divide the sequence length {tokens.shape[1]}")
    return lm_loss(model.lm_head, backbone(model, tokens, cfg), tokens, cfg)


def head_logits(lm_head, h, cfg: TransformerConfig, softcap=True, batch="dp"):
    """float32 logits of hidden rows ``h`` [B, d] through ``lm_head``, soft-capped
    as the decode step does (``softcap=False``: as the prefill step does).
    Under rules the rows' features and the head's FSDP-sharded rows are
    gathered: the logits split the batch (the logical name ``batch``) and
    the vocabulary."""
    logits = _matmul(constrain(h, batch, None), constrain(lm_head, None, "vocab")).float()
    if softcap and cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def lm_logits(model: Transformer, h, cfg: Optional[TransformerConfig] = None, softcap=True,
              batch="dp"):
    """:func:`head_logits` through the model's ``lm_head``."""
    return head_logits(model.lm_head, h, cfg or model.cfg, softcap, batch)


# ---------------------------------------------------------------- decode


def kv_cache_specs(cfg: TransformerConfig, batch: int, max_len: int):
    dt = cfg.param_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    logical = ("layers", "cache_batch", "seq", "kv_heads", None)
    return {
        "k": ArraySpec(shape, logical, dt, "zeros"),
        "v": ArraySpec(shape, logical, dt, "zeros"),
    }


@torch.no_grad()
def prefill(model: Transformer, tokens, cfg: Optional[TransformerConfig] = None,
            max_len: Optional[int] = None):
    """Build the KV cache for a prompt; returns (cache, last hidden [B, d]).

    The cache has ``max_len`` slots (default S, the reference's cache), the
    prompt's k/v in slots [0, S) and zeros past them, allocated once. Under
    rules the cache is laid out as its spec names (each rank allocating its
    shard), and then it has S slots.
    """
    cfg = cfg or model.cfg
    B, S = tokens.shape
    max_len = S if max_len is None else max_len
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    tokens = constrain(tokens, "dp", None)
    x = constrain(_embed(model, tokens), *_BOUNDARY)
    cache = {name: zeros(s.shape, s.dtype, x.device, *s.logical)
             for name, s in kv_cache_specs(cfg, B, max_len).items()}
    if isinstance(cache["k"], DTensor) and max_len != S:
        raise ValueError(f"prefill: a laid-out cache holds the prompt's {S} slots, not {max_len}")
    positions = torch.arange(S, device=x.device)[None, :]
    x = _run_layers(model, x, positions, cfg, cache)
    return cache, rmsnorm(x[:, -1], model.ln_f, cfg.norm_eps)


def _decode_attention(qh, kk, vv, kc, vc, cache_len: int, start: int = 0, groups=()):
    """One token's attention: ``qh`` [B, Kv, G, D] against the cache slots
    ``kc``/``vc`` [B, S, Kv, D] (global slots ``start + j``; those at or past
    ``cache_len`` masked) and its own ``kk``/``vv`` [B, 1, Kv, D], all in one
    softmax -> [B, Kv, G, D] float32. With ``groups`` (the process groups
    over which the cache's slots are split) each rank holds one block of
    the slots: the max, the sum of exponentials and the weighted values are
    reduced across the blocks (the token's own slot counted on the block at
    ``start == 0``)."""
    B, Kv, G, D = qh.shape
    S = kc.shape[1]
    s_cache = torch.stack([_matmul_f32(qh[b], kc[b].permute(1, 2, 0)) for b in range(B)])
    s_self = _matmul_f32(qh, kk.reshape(B, Kv, D, 1))  # [B, Kv, G, 1]
    s = torch.cat([s_cache, s_self], dim=-1) / np.float32(np.sqrt(D))
    past = torch.arange(start, start + S, device=s.device) >= int(cache_len)  # masked slots
    s[..., :S].masked_fill_(past, -1e30)
    if not groups:
        p = _softmax_(s).to(vc.dtype)
        attn = torch.stack([_matmul_f32(p[b, ..., :S], vc[b].permute(1, 0, 2)) for b in range(B)])
        return attn + p[..., S:].float() * vv.reshape(B, Kv, 1, D).float()
    from torch.distributed import _functional_collectives as funcol

    def across(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return t

    if start:
        s[..., S:] = -1e30
    e = s.sub_(across(s.amax(-1, keepdim=True), "max")).exp_()
    den = across(e.sum(-1, keepdim=True), "sum")
    p = e.to(vc.dtype)
    num = torch.stack([_matmul_f32(p[b, ..., :S], vc[b].permute(1, 0, 2)) for b in range(B)])
    num = num + p[..., S:].float() * vv.reshape(B, Kv, 1, D).float()
    return across(num, "sum") / den


def _decode_attention_sharded(qh, kk, vv, kc, vc, cache_len: int):
    """:func:`_decode_attention` of DTensors, on each rank's shard through
    ``local_map``: q and the new k/v laid out as the cache's batch and heads,
    the cache's slots split over the mesh dimensions (the groups) that split
    its sequence. The result is placed as q, replicated over those."""
    mesh, place = kc.device_mesh, tuple(kc.placements)
    if any(p.is_partial() or (p.is_shard() and p.dim == 3) for p in place):
        raise ValueError(f"decode attention: cache placed {place}")
    seq_dims = [d for d, p in enumerate(place) if p.is_shard(1)]
    qp = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate() for p in place]
    kvp = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2) else Replicate() for p in place]
    qh = qh.redistribute(mesh, qp)
    kk, vv = (t.redistribute(mesh, kvp) for t in (kk, vv))
    if vc.placements != kc.placements:
        raise ValueError(f"decode attention: k and v caches placed {place}, {vc.placements}")
    block = kc.to_local().shape[1]
    if block * math.prod(mesh.size(d) for d in seq_dims) != kc.shape[1]:
        raise ValueError(f"decode attention: {kc.shape[1]} slots unevenly over {seq_dims}")
    index = 0  # this rank's block of slots, the mesh dimensions major to minor
    for d in seq_dims:
        index = index * mesh.size(d) + mesh.get_local_rank(d)
    groups = tuple(mesh.get_group(d) for d in seq_dims)
    fn = functools.partial(_decode_attention, cache_len=cache_len, start=index * block,
                           groups=groups)
    layout = [list(qp), list(kvp), list(kvp), list(place), list(place)]
    return local_map(fn, out_placements=list(qp), in_placements=layout,
                     device_mesh=mesh)(qh, kk, vv, kc, vc)


def decode_layer(x, lp, kc, vc, cache_len: int, cfg: TransformerConfig, freqs):
    """One layer of :func:`decode_step`: x [B, 1, d] against this layer's
    cache ``kc``/``vc`` [B, S_max, Kv, D] (read in place) -> (x, k, v), the
    new k/v [B, 1, Kv, D] in the cache's dtype."""
    B = x.shape[0]
    Kv, D, G = cfg.n_kv, cfg.d_head, cfg.n_heads // cfg.n_kv
    pos = torch.full((B, 1), int(cache_len), dtype=torch.int32, device=x.device)
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, kk, vv = _qkv(h, lp, cfg, pos, freqs, lead=_DECODE[:2])
    kk, vv = kk.to(kc.dtype), vv.to(vc.dtype)
    # q's heads grouped by their k/v head: split as the cache's k/v heads
    qh = constrain(q, "cache_batch", None, "kv_heads", None).reshape(B, Kv, G, D)
    if isinstance(kc, DTensor):
        attn = _decode_attention_sharded(qh, kk, vv, kc, vc, cache_len)
    else:
        attn = _decode_attention(qh, kk, vv, kc, vc, cache_len)
    attn = attn.reshape(B, 1, cfg.n_heads, D)
    x = x + constrain(_out_proj(attn.to(x.dtype), lp["wo"]), *_DECODE)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + constrain(_ffn(h2, lp, cfg, _DECODE[:2]), *_DECODE).to(x.dtype)
    return x, kk, vv


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, token, cache_len,
                cfg: Optional[TransformerConfig] = None):
    """One decode step. token [B] int; cache_len the number of filled slots.

    The token attends to the cache slots [0, cache_len) and to itself: its
    scores against the whole cache (masked past ``cache_len``) and against
    its own k are one softmax, its own v added after the cache's product.
    Returns (logits [B, V] float32, new k/v [L, B, 1, Kv, D]); the caller
    commits them (``make_lm_decode`` does, in place, :func:`commit_kv`).
    """
    cfg = cfg or model.cfg
    token = constrain(token, "cache_batch")
    x = constrain(_embed(model, token)[:, None], *_DECODE)  # [B, 1, d]
    knew, vnew = [], []
    for i in range(cfg.n_layers):
        x, kk, vv = decode_layer(x, model.layer_params(i), cache["k"][i], cache["v"][i],
                                 cache_len, cfg, model.rope_freqs)
        knew.append(kk)
        vnew.append(vv)
    x = rmsnorm(x, model.ln_f, cfg.norm_eps)
    logits = lm_logits(model, x[:, 0], cfg, batch="cache_batch")
    return logits, (torch.stack(knew), torch.stack(vnew))


def commit_kv(cache: dict, knew, vnew, slot: int) -> None:
    """Write the new k/v [L, B, 1, Kv, D] into slot ``slot`` of the cache
    [L, B, S, Kv, D], in place; on a laid-out cache each rank writes into its
    own block of the slots (the one that holds ``slot``, if any)."""
    for name, new in (("k", knew), ("v", vnew)):
        c = cache[name]
        if not isinstance(c, DTensor):
            c[:, :, slot] = new[:, :, 0]
            continue
        mesh, place = c.device_mesh, tuple(c.placements)
        layout = [Replicate() if p.is_shard(2) else p for p in place]
        local, new_local = c.to_local(), new.redistribute(mesh, layout).to_local()
        block = local.shape[2]
        index = 0
        for d, p in enumerate(place):
            if p.is_shard(2):
                index = index * mesh.size(d) + mesh.get_local_rank(d)
        if index * block <= slot < (index + 1) * block:
            local[:, :, slot - index * block] = new_local[:, :, 0]
