"""Resumable matching state, the paper's robustness property.

The semi-streaming formulation keeps *all* algorithm state in a small
per-vertex bit block (``mb[n, ceil(L/8)]`` packed, ``[n, L]`` dense) plus
the recorded-edge prefix of ``assigned``, updated by one sequential pass
over the edge stream. So the computation can be checkpointed at any
stream position: :class:`MatchState` is exactly that state plus a
fingerprint of the run, and the epoch executor
(:func:`repro_torch.kernels.substream_match.ops.match_epochs`) threads it
through the engines. A resumed run is bit-identical to the uninterrupted
one, because greedy matching is confluent in the carried bits.

The state lives on the host, in numpy, as the JAX package's
``repro.core.state`` does, and its bytes are the same: a state made by
one package resumes in the other (``metadata()`` / ``to_arrays()`` on one
side, :meth:`MatchState.from_arrays` on the other;
:func:`repro_torch.convert.state_from_reference` checks the types).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core.types import EdgeStream, MatchingResult, SubstreamConfig, to_numpy

#: Format version stamped into states (the JAX package's); bump on layout
#: changes so a stale state fails loudly instead of deserializing garbage.
STATE_VERSION = 1

#: the stream arrays' types, whose bytes the fingerprint hashes
_STREAM_DTYPES = (np.int32, np.int32, np.float32, np.bool_)


def fingerprint_for(stream: EdgeStream, cfg: SubstreamConfig, packed: bool) -> str:
    """Content hash binding a state to (stream, cfg, storage layout).

    sha256 over the config scalars and the raw bytes of the stream arrays
    as int32 src/dst, float32 weight and bool valid, truncated to 16 hex
    characters; byte for byte the JAX package's ``fingerprint_for``, so
    that its states are accepted here and the other way round. Resuming
    against another stream or config would silently give a wrong
    matching; the fingerprint turns that into
    :class:`repro_torch.checkpoint.snapshots.SnapshotMismatchError`.
    """
    h = hashlib.sha256()
    h.update(
        f"v{STATE_VERSION}|n={cfg.n}|L={cfg.L}|eps={cfg.eps!r}|"
        f"packed={bool(packed)}|m={stream.num_edges}|".encode()
    )
    for arr, dtype in zip((stream.src, stream.dst, stream.weight, stream.valid), _STREAM_DTYPES):
        h.update(np.ascontiguousarray(to_numpy(arr), dtype=dtype).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class MatchState:
    """Everything Part 1 needs to continue from stream position ``pos``.

    ``assigned`` holds the per-edge substream for the consumed prefix
    (``-1`` beyond ``pos``), ``mb`` the matching-bit block in the run's
    storage (uint8 ``[n, ceil(L/8)]`` packed / bool ``[n, L]`` dense), and
    ``recorded_counts`` the per-substream recorded-edge cursors ``|C_i|``,
    redundant with ``assigned`` by construction: :meth:`problems`
    recomputes them, so a torn or mixed-up state fails the check.
    """

    fingerprint: str
    pos: int
    num_edges: int
    n: int
    L: int
    packed: bool
    assigned: np.ndarray  # int32 [num_edges]; -1 beyond pos
    mb: np.ndarray  # uint8 [n, W] packed / bool [n, L] dense
    recorded_counts: np.ndarray  # int64 [L]

    @staticmethod
    def initial(stream: EdgeStream, cfg: SubstreamConfig, packed: bool) -> "MatchState":
        """The pos-0 zero state of a fresh run."""
        words = bitpack.packed_width(max(cfg.L, 1))
        mb = np.zeros((cfg.n, words), np.uint8) if packed else np.zeros((cfg.n, cfg.L), bool)
        return MatchState(
            fingerprint=fingerprint_for(stream, cfg, packed),
            pos=0,
            num_edges=stream.num_edges,
            n=cfg.n,
            L=cfg.L,
            packed=bool(packed),
            assigned=np.full(stream.num_edges, -1, np.int32),
            mb=mb,
            recorded_counts=np.zeros(cfg.L, np.int64),
        )

    def advance(self, result: MatchingResult, end: int) -> "MatchState":
        """Fold one epoch's result (edges ``[pos, end)``) into the state.

        ``result`` is the engine's output for the epoch's slice run with
        ``mb0 = self.mb``: its ``assigned`` covers ``end - pos`` edges and
        its bit block *replaces* the carried one (the engines carry it
        through, so it is the cumulative block, not a delta). Tensors on
        the card are copied to the host.
        """
        if not self.pos <= end <= self.num_edges:
            raise ValueError(f"epoch end {end} outside [{self.pos}, {self.num_edges}]")
        epoch_assigned = to_numpy(result.assigned).astype(np.int32, copy=False)
        if epoch_assigned.shape != (end - self.pos,):
            raise ValueError(
                f"epoch result covers {epoch_assigned.shape} edges, "
                f"expected {(end - self.pos,)}"
            )
        assigned = self.assigned.copy()
        assigned[self.pos : end] = epoch_assigned
        hits = epoch_assigned[epoch_assigned >= 0]
        counts = self.recorded_counts + np.bincount(hits, minlength=self.L).astype(np.int64)
        mb = (
            to_numpy(result.mb_packed).astype(np.uint8, copy=False)
            if self.packed
            else to_numpy(result.mb).astype(bool, copy=False)
        )
        return dataclasses.replace(
            self, pos=int(end), assigned=assigned, recorded_counts=counts, mb=mb
        )

    @property
    def done(self) -> bool:
        return self.pos == self.num_edges

    @property
    def mb0(self) -> np.ndarray | None:
        """The carried bit block as ``substream_match``'s ``mb0`` operand
        (``None`` at pos 0: a fresh run starts from zeros)."""
        return None if self.pos == 0 else self.mb

    def result(self, device="cpu") -> MatchingResult:
        """The completed run as a :class:`MatchingResult` of tensors on
        ``device`` (requires ``done``: a partial state has no matching)."""
        if not self.done:
            raise ValueError(f"run incomplete: pos {self.pos} of {self.num_edges} edges")
        assigned = torch.from_numpy(self.assigned.copy()).to(device)
        mb = torch.from_numpy(self.mb.copy()).to(device)
        if self.packed:
            return MatchingResult(assigned=assigned, mb_packed=mb, L=self.L)
        return MatchingResult(assigned=assigned, mb=mb)

    def problems(self) -> list[str]:
        """Structural integrity check; ``[]`` when consistent.

        Shape and range checks plus the redundancy check: the
        recorded-count cursors must equal a recount of ``assigned``, so a
        torn state (bit block of one epoch, assigned of another) fails
        even though each array alone looks fine.
        """
        out = []
        words = bitpack.packed_width(max(self.L, 1))
        want_mb = (self.n, words) if self.packed else (self.n, self.L)
        if tuple(self.mb.shape) != want_mb:
            out.append(f"mb shape {self.mb.shape} != {want_mb}")
        if self.assigned.shape != (self.num_edges,):
            out.append(f"assigned shape {self.assigned.shape} != {(self.num_edges,)}")
        if not 0 <= self.pos <= self.num_edges:
            out.append(f"pos {self.pos} outside [0, {self.num_edges}]")
            return out
        if self.assigned.size:
            lo, hi = int(self.assigned.min()), int(self.assigned.max())
            if lo < -1 or hi >= self.L:
                out.append(f"assigned values [{lo}, {hi}] outside [-1, {self.L})")
        if (self.assigned[self.pos :] != -1).any():
            out.append("assigned set beyond pos")
        if self.recorded_counts.shape != (self.L,):
            out.append(f"recorded_counts shape {self.recorded_counts.shape} != {(self.L,)}")
        else:
            prefix = self.assigned[: self.pos]
            hits = prefix[prefix >= 0]
            want = np.bincount(hits, minlength=self.L).astype(np.int64)
            if not np.array_equal(want, self.recorded_counts):
                out.append("recorded_counts disagree with assigned recount")
        return out

    def to_arrays(self) -> dict[str, np.ndarray]:
        """The array payload; ``mb`` is stored as uint8 in either storage."""
        return {
            "assigned": self.assigned,
            "mb": self.mb.astype(np.uint8),
            "recorded_counts": self.recorded_counts,
        }

    def metadata(self) -> dict:
        """The JSON-safe scalars of the state."""
        return {
            "state_version": STATE_VERSION,
            "fingerprint": self.fingerprint,
            "pos": int(self.pos),
            "num_edges": int(self.num_edges),
            "n": int(self.n),
            "L": int(self.L),
            "packed": bool(self.packed),
        }

    @staticmethod
    def from_arrays(meta: dict, arrays: dict) -> "MatchState":
        """Rebuild from :meth:`metadata` + :meth:`to_arrays` payloads (this
        package's or the JAX package's). Raises ``ValueError`` on another
        ``state_version``."""
        if int(meta.get("state_version", STATE_VERSION)) != STATE_VERSION:
            raise ValueError(
                f"state_version {meta['state_version']} != {STATE_VERSION}"
            )
        packed = bool(meta["packed"])
        mb = np.asarray(arrays["mb"], np.uint8)
        return MatchState(
            fingerprint=str(meta["fingerprint"]),
            pos=int(meta["pos"]),
            num_edges=int(meta["num_edges"]),
            n=int(meta["n"]),
            L=int(meta["L"]),
            packed=packed,
            assigned=np.asarray(arrays["assigned"], np.int32),
            mb=mb if packed else mb.astype(bool),
            recorded_counts=np.asarray(arrays["recorded_counts"], np.int64),
        )
