"""Core data types: the edge stream, the substream configuration and the
Part-1 result.

An edge stream is a struct-of-arrays ``src[i], dst[i], weight[i]`` in
*stream order*, the order the paper's FPGA would receive the edges. Every
matcher treats the stream order as the greedy priority order, as Listing 1
of the paper does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bitpack

_I32 = np.iinfo(np.int32)
#: the matching-bit storages :class:`SubstreamConfig` takes
MB_LAYOUTS = ("packed", "unpacked")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    A CUDA device comes back with its index (``cuda:<current>`` for
    ``None`` or ``"cuda"``), the name its tensors carry, so a stream
    already there compares equal to it. Raises ``RuntimeError`` when a CUDA
    device is asked for and there is none; nothing falls back to the CPU
    unless the caller asks for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (copied off the card) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _int32_cast_faults(a: np.ndarray) -> np.ndarray:
    """bool mask: True where ``a.astype(np.int32)`` would change the value."""
    if a.dtype == np.int32 or a.dtype == bool:
        return np.zeros(a.shape, bool)
    if np.issubdtype(a.dtype, np.integer):
        return (a < _I32.min) | (a > _I32.max)
    if np.issubdtype(a.dtype, np.floating):
        with np.errstate(invalid="ignore"):
            bad = ~np.isfinite(a) | (a < _I32.min) | (a > _I32.max)
            frac = np.zeros(a.shape, bool)
            ok = ~bad
            frac[ok] = a[ok] != np.trunc(a[ok])
        return bad | frac
    try:  # exotic dtypes (object arrays of python ints): round-trip via int64
        a64 = a.astype(np.int64)
    except (TypeError, ValueError, OverflowError):
        return np.ones(a.shape, bool)
    return (a64 < _I32.min) | (a64 > _I32.max)


@dataclasses.dataclass(frozen=True)
class EdgeStream:
    """A weighted edge stream on one device: ``src``/``dst`` int32 [m],
    ``weight`` float32 [m], ``valid`` bool [m].

    ``valid`` masks padding edges; every matcher ignores False entries.
    """

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    valid: torch.Tensor

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device, telemetry=obs.DISABLED) -> "EdgeStream":
        """The same stream on ``device``, named as :func:`resolve_device`
        names it (itself when already there).

        ``telemetry`` records a ``stream.to`` span where the stream is not
        on ``device`` already, with its ``bytes`` and the ``source`` and
        ``target`` devices as args."""
        device = resolve_device(device)
        if self.src.device == device:
            return self
        cuda = device if device.type == "cuda" else self.src.device
        with telemetry.span("stream.to", sync=cuda) as span:
            if telemetry.enabled:
                span.note(bytes=self.nbytes, source=str(self.src.device),
                          target=str(device))
            return EdgeStream(
                *(t.to(device) for t in (self.src, self.dst, self.weight, self.valid))
            )

    @property
    def nbytes(self) -> int:
        """Bytes of the stream's four arrays."""
        return sum(t.nbytes for t in (self.src, self.dst, self.weight, self.valid))

    @staticmethod
    def from_numpy(
        src, dst, weight, n_pad: Optional[int] = None, policy: str = "strict",
        device=None,
    ) -> "EdgeStream":
        """Build a stream from host arrays, guarding the narrowing casts.

        An int64 vertex id wraps modulo 2^32 under the int32 cast, and a
        float64 weight can overflow to Inf under the float32 cast.
        ``policy`` says what happens to such entries:

        * ``"strict"`` (default): raise
          :class:`repro_torch.core.guard.StreamValidationError` naming the
          offending positions;
        * ``"sanitize"``: drop those edges (``valid=False``, slots zeroed
          like padding);
        * ``"off"``: the plain wrap/NaN-propagating cast.

        ``n_pad`` pads the stream with invalid edges up to that length.
        ``device=None`` puts the stream on the CUDA card.
        """
        if policy not in ("strict", "sanitize", "off"):
            raise ValueError(
                f"unknown policy {policy!r}; use 'strict', 'sanitize' or 'off'"
            )
        dev = resolve_device(device)
        src_in = np.asarray(src)
        dst_in = np.asarray(dst)
        w_in = np.asarray(weight)
        m = src_in.shape[0]
        if dst_in.shape[0] != m or w_in.shape[0] != m:
            raise ValueError(
                f"src/dst/weight lengths differ: "
                f"{m}/{dst_in.shape[0]}/{w_in.shape[0]}"
            )
        drop = np.zeros(m, bool)
        if policy != "off" and m:
            from repro_torch.core import guard  # deferred: guard imports this module

            bad_id = _int32_cast_faults(src_in) | _int32_cast_faults(dst_in)
            with np.errstate(invalid="ignore", over="ignore"):
                bad_w = ~np.isfinite(w_in.astype(np.float32))
            problems = [
                guard._problem(kind, mask, detail=detail)
                for kind, mask, detail in (
                    ("id_overflow", bad_id, "vertex id not representable as int32"),
                    ("nonfinite_weight", bad_w, "weight non-finite after the float32 cast"),
                )
                if mask.any()
            ]
            if problems:
                if policy == "strict":
                    raise guard.StreamValidationError(problems)
                drop = bad_id | bad_w
        with np.errstate(invalid="ignore", over="ignore"):
            src_np = np.where(drop, 0, src_in).astype(np.int32)
            dst_np = np.where(drop, 0, dst_in).astype(np.int32)
            w_np = np.where(drop, 0.0, w_in).astype(np.float32)
        m_pad = m if n_pad is None else n_pad
        if m_pad < m:
            raise ValueError(f"pad {m_pad} < m {m}")
        pad = m_pad - m
        z = np.zeros(pad, np.int32)
        arrays = (
            np.concatenate([src_np, z]),
            np.concatenate([dst_np, z]),
            np.concatenate([w_np, np.zeros(pad, np.float32)]),
            np.concatenate([~drop, np.zeros(pad, bool)]),
        )
        return EdgeStream(*(torch.from_numpy(a).to(dev) for a in arrays))


class SubstreamConfig:
    """Parameters of the Crouch–Stubbs reduction.

    ``L`` substreams; substream ``i`` admits edges with ``w >= thr[i]``,
    where ``thr[i]`` is ``(1 + eps)**i`` in float32. ``thresholds``, when
    given, is that float32 ``[L]`` vector explicitly: float32 powers are
    not bit-identical across implementations (the JAX package's jitted
    vector differs from PyTorch's at eps=0.1, L=64 in lanes 32 and 56), and
    an edge whose weight falls between two candidates lands in another
    substream. Every consumer in this package (the kernel, its plain
    versions and the guard) reads the one vector :meth:`thresholds`
    returns. Without it the vector is PyTorch's float32
    ``(1 + eps) ** arange(L)``, computed once on the host.

    The vector must be non-decreasing (``ValueError`` otherwise): the
    eligibility word of an edge is then the prefix of the thresholds it
    passes, which the mega kernel reads as a count.

    ``mb_layout`` is the matching-bit storage: ``"packed"`` uint8 bit
    planes (the §4.3 BRAM-word analogue) or ``"unpacked"`` (one int8 byte
    per substream, dense ``bool [n, L]`` results); any other value raises
    ``ValueError``.
    """

    __slots__ = ("n", "L", "eps", "mb_layout", "_thr")

    def __init__(
        self, n: int, L: int, eps: float = 0.1, mb_layout: str = "packed",
        thresholds=None,
    ):
        if mb_layout not in MB_LAYOUTS:
            raise ValueError(f"unknown mb_layout {mb_layout!r}; use one of {MB_LAYOUTS}")
        if thresholds is None:
            thr = ((1.0 + eps) ** torch.arange(L, dtype=torch.float32)).numpy()
        else:
            thr = np.array(thresholds, dtype=np.float32)
            if thr.shape != (L,):
                raise ValueError(f"thresholds shape {thr.shape} != ({L},)")
        if not (thr[1:] >= thr[:-1]).all() or np.isnan(thr).any():
            raise ValueError("thresholds must be non-decreasing (and not NaN)")
        thr.flags.writeable = False
        for name, value in (
            ("n", int(n)), ("L", int(L)), ("eps", float(eps)),
            ("mb_layout", mb_layout), ("_thr", thr),
        ):
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        raise dataclasses.FrozenInstanceError(f"cannot assign to field {name!r}")

    def thresholds(self) -> np.ndarray:
        """float32 [L] substream admission thresholds (read-only)."""
        return self._thr

    def __repr__(self) -> str:
        return (
            f"SubstreamConfig(n={self.n}, L={self.L}, eps={self.eps}, "
            f"mb_layout={self.mb_layout!r})"
        )


class MatchingResult:
    """Output of Part 1 (stream processing).

    ``assigned`` int32 [m]: the substream index whose list ``C[i]``
    records the edge (the *highest* eligible substream where both
    endpoints were free), or -1 if the edge entered no list.

    The matching bits are held in one of two storages:

    * ``mb`` bool [n, L], the dense view;
    * ``mb_packed`` uint8 [n, ceil(L/8)], the bit planes of
      :mod:`repro_torch.core.bitpack`.

    ``.mb`` is always readable: when only the packed storage is present it
    is unpacked on access. ``L`` records the substream count; it is
    required with packed storage alone, since the packed width cannot
    recover ``L`` when ``L % 8 != 0``.
    """

    __slots__ = ("assigned", "_mb", "_mb_packed", "_L")

    def __init__(self, assigned, mb=None, mb_packed=None, L=None):
        if mb is None and mb_packed is None:
            raise ValueError("MatchingResult needs mb or mb_packed")
        if L is None:
            if mb is None:
                raise ValueError(
                    "L is required when only mb_packed is given "
                    "(the packed width cannot recover L when L % 8 != 0)"
                )
            L = mb.shape[-1]
        object.__setattr__(self, "assigned", assigned)
        object.__setattr__(self, "_mb", mb)
        object.__setattr__(self, "_mb_packed", mb_packed)
        object.__setattr__(self, "_L", int(L))

    def __setattr__(self, name, value):
        raise dataclasses.FrozenInstanceError(f"cannot assign to field {name!r}")

    @property
    def L(self) -> int:
        return self._L

    @property
    def mb(self) -> torch.Tensor:
        """bool [n, L] dense matching bits (unpacked on access if packed)."""
        if self._mb is not None:
            return self._mb if self._mb.dtype == torch.bool else self._mb.to(torch.bool)
        return bitpack.unpack_bits(self._mb_packed, self._L)

    @property
    def mb_packed(self) -> Optional[torch.Tensor]:
        """uint8 [n, ceil(L/8)] packed storage, or None if produced dense."""
        return self._mb_packed

    @property
    def is_packed(self) -> bool:
        return self._mb_packed is not None

    def packed(self) -> torch.Tensor:
        """uint8 [n, ceil(L/8)] packed bits (packing the dense view if needed)."""
        if self._mb_packed is not None:
            return self._mb_packed
        return bitpack.pack_bits(self.mb)

    def with_assigned(self, assigned) -> "MatchingResult":
        """Same bit storage, different ``assigned`` (e.g. un-permuted)."""
        return MatchingResult(
            assigned, mb=self._mb, mb_packed=self._mb_packed, L=self._L
        )

    def __repr__(self) -> str:
        store = "packed" if self.is_packed else "dense"
        return f"MatchingResult(assigned={self.assigned!r}, storage={store}, L={self._L})"
