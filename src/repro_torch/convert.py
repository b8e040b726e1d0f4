"""State carried across from the JAX package.

The system has no weights: what crosses over is its input and its carried
state, the edge stream, the float32 threshold vector, the matching bits
(packed or dense), a resumable ``MatchState`` and the host-built wave
schedule. Every function takes host numpy arrays (``np.asarray`` of the
JAX package's arrays), never JAX objects, and keeps their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import MatchState
from repro_torch.core.types import (
    EdgeStream,
    MatchingResult,
    SubstreamConfig,
    resolve_device,
    to_numpy,
)
from repro_torch.graph.waves import WaveSchedule


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
