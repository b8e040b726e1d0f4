"""State carried across from the JAX package.

What crosses over: the matcher's input and carried state (the edge
stream, the float32 threshold vector, the matching bits, packed or dense,
a resumable ``MatchState`` and the host-built wave schedule), the models'
configs and parameters (a parameter pytree as nested dicts and lists,
loaded into a module whose ``state_dict`` keys are the tree's paths; the
transformer's RoPE frequency vector as a buffer) and AdamW state. Every function takes host numpy arrays (``np.asarray`` of the JAX
package's arrays), never JAX objects, and keeps their bits; the
``*_to_reference`` functions give them back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.state import MatchState
from repro_torch.core.types import (
    EdgeStream,
    MatchingResult,
    SubstreamConfig,
    resolve_device,
    to_numpy,
)
from repro_torch.graph.waves import WaveSchedule
from repro_torch.models.bert4rec import Bert4RecConfig
from repro_torch.models.transformer import TransformerConfig


def _exact(name: str, a, dtype) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != dtype:
        raise ValueError(f"{name}: want {np.dtype(dtype)}, got {a.dtype}")
    return np.array(a)  # a writable copy: torch.from_numpy shares memory


def stream_from_arrays(src, dst, weight, valid, device=None) -> EdgeStream:
    """A stream holding exactly the given arrays: the numpy views of a JAX
    ``EdgeStream`` (int32 src/dst, float32 weight, bool valid)."""
    arrays = (
        _exact("src", src, np.int32),
        _exact("dst", dst, np.int32),
        _exact("weight", weight, np.float32),
        _exact("valid", valid, np.bool_),
    )
    if len({a.shape for a in arrays}) != 1 or arrays[0].ndim != 1:
        raise ValueError(f"shapes differ: {[a.shape for a in arrays]}")
    dev = resolve_device(device)
    return EdgeStream(*(torch.from_numpy(a).to(dev) for a in arrays))


def config_from_reference(n: int, L: int, eps: float, thresholds, mb_layout: str = "packed"):
    """A config whose thresholds are the reference's float32 [L] vector
    (its engines compute ``cfg.thresholds()`` under jit)."""
    return SubstreamConfig(
        n, L, eps, mb_layout=mb_layout,
        thresholds=_exact("thresholds", thresholds, np.float32),
    )


def mb0_from_reference(mb, device=None) -> torch.Tensor:
    """Carried matching bits in either storage: packed uint8
    [n, ceil(L/8)] or dense bool [n, L]."""
    a = np.asarray(mb)
    dtype = np.bool_ if a.dtype == np.bool_ else np.uint8
    return torch.from_numpy(_exact("mb", a, dtype)).to(resolve_device(device))


def state_from_reference(meta: dict, arrays: dict) -> MatchState:
    """The port's state from a JAX ``MatchState``'s ``metadata()`` and
    ``to_arrays()`` (int32 assigned, uint8 mb, int64 recorded counts), so
    that a run begun there finishes here; its fingerprint is the same."""
    return MatchState.from_arrays(dict(meta), {
        "assigned": _exact("assigned", arrays["assigned"], np.int32),
        "mb": _exact("mb", arrays["mb"], np.uint8),
        "recorded_counts": _exact("recorded_counts", arrays["recorded_counts"], np.int64),
    })


def schedule_from_reference(wave, order, offsets, slots, seg_offsets) -> WaveSchedule:
    """The port's wave schedule holding exactly the arrays of a reference
    ``repro.graph.waves.WaveSchedule`` (all int32), so that both packages
    run on one schedule."""
    wave = _exact("wave", wave, np.int32)
    return WaveSchedule(
        wave=wave,
        order=_exact("order", order, np.int32),
        offsets=_exact("offsets", offsets, np.int32),
        slots=_exact("slots", slots, np.int32),
        seg_offsets=_exact("seg_offsets", seg_offsets, np.int32),
        num_edges=int(wave.shape[0]),
    )


def result_to_numpy(result: MatchingResult):
    """(assigned int32 [m], bits) on the host, the bits in the result's own
    storage: mb_packed uint8 [n, ceil(L/8)], or mb bool [n, L] when dense."""
    bits = result.mb_packed if result.is_packed else result.mb
    return to_numpy(result.assigned), to_numpy(bits)


def _flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def _unflatten(flat: dict):
    """Nested dicts from dotted paths, a dict whose keys are 0..k-1 a list."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def _load(tensors: dict, tree, what: str) -> None:
    flat = _flatten(tree)
    if set(flat) != set(tensors):
        raise ValueError(f"{what}: keys differ: only in the reference "
                         f"{sorted(set(flat) - set(tensors))}, only here "
                         f"{sorted(set(tensors) - set(flat))}")
    with torch.no_grad():
        for name, t in tensors.items():
            a = np.asarray(flat[name])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{what}: {name} has shape {a.shape}, want {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)).to(t.dtype))


def params_from_reference(module: nn.Module, tree, buffers: dict | None = None) -> nn.Module:
    """Load a JAX parameter pytree (nested dicts and lists of float32 numpy
    arrays) into ``module``; its key set and every shape must equal the
    module's. ``buffers`` ({name: float32 array}) replaces buffers of the
    module bit for bit: the reference's jitted RoPE frequencies as
    ``{"rope_freqs": ...}`` (``models/transformer.py::rope_freqs``)."""
    _load(dict(module.named_parameters()), tree, "params_from_reference")
    own = dict(module.named_buffers())
    for name, a in (buffers or {}).items():
        if name not in own:
            raise ValueError(f"params_from_reference: no buffer {name!r}; have {sorted(own)}")
        a = _exact(name, a, np.float32)
        if tuple(a.shape) != tuple(own[name].shape):
            raise ValueError(f"{name} has shape {a.shape}, want {tuple(own[name].shape)}")
        with torch.no_grad():
            own[name].copy_(torch.from_numpy(a))
    return module


def params_to_reference(module: nn.Module):
    """The module's parameters as the reference's pytree of numpy arrays."""
    return _unflatten({k: to_numpy(p) for k, p in module.named_parameters()})


def opt_state_from_reference(opt, module: nn.Module, state: dict):
    """Load a JAX AdamW state ``{m, v, count}`` (``repro.optim.adamw_init``'s
    layout) into ``opt``, an :class:`repro_torch.optim.AdamW` over
    ``module``'s parameters."""
    params = dict(module.named_parameters())
    for key in ("m", "v"):
        moments = {}
        for name, p in params.items():
            st = opt.state[p]
            if key not in st:
                st[key] = torch.zeros_like(p, dtype=torch.float32)
            moments[name] = st[key]
        _load(moments, state[key], f"opt_state_from_reference[{key}]")
    count = _exact("count", np.asarray(state["count"]).reshape(()), np.int32)
    opt.count.copy_(torch.from_numpy(count))
    return opt


def opt_state_to_reference(opt, module: nn.Module) -> dict:
    """``opt``'s state as the reference's ``{m, v, count}`` of numpy arrays."""
    params = dict(module.named_parameters())
    out = {key: _unflatten({k: to_numpy(opt.state[p][key]) for k, p in params.items()})
           for key in ("m", "v")}
    out["count"] = to_numpy(opt.count)
    return out


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy or ``jnp`` dtype (``jnp.bfloat16`` too)."""
    return getattr(torch, np.dtype(dtype).name)


def _config_from_reference(cls, cfg, dtype_field: str):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)}
    fields[dtype_field] = _torch_dtype(fields[dtype_field])
    return cls(**fields)


def transformer_config_from_reference(cfg):
    """The port's ``TransformerConfig`` with every field of a reference
    ``repro.models.transformer.TransformerConfig``, ``param_dtype`` as the
    torch dtype."""
    return _config_from_reference(TransformerConfig, cfg, "param_dtype")


def bert4rec_config_from_reference(cfg):
    """The port's ``Bert4RecConfig`` with every field of a reference
    ``repro.models.bert4rec.Bert4RecConfig``, ``dtype`` as the torch dtype."""
    return _config_from_reference(Bert4RecConfig, cfg, "dtype")
