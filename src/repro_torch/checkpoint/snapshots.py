"""Crash-safe :class:`repro_torch.core.state.MatchState` snapshots.

A thin policy layer over :class:`repro_torch.checkpoint.manager.CheckpointManager`
(which owns the write-tmp-fsync-rename commit protocol): the epoch
executor commits the carried state after every epoch, and resume loads
the latest committed step, validates it against the run it is being
resumed *into* (config fingerprint, format version, structural
integrity), and replays only the remaining stream suffix. The layout on
disk is the JAX package's (``step_{pos:08d}/match_state.npz`` with keys
``assigned``, ``mb``, ``recorded_counts``, and ``manifest.json``), so a
snapshot directory written by either package resumes in the other.

Validation failures are structured:

* :class:`SnapshotMismatchError`: the state belongs to a different
  (stream, config, storage) triple; resuming would compute a wrong
  matching, so this is always an error, never a silent fresh start.
* :class:`SnapshotCorruptError`: the state is internally inconsistent
  (torn arrays, recorded-count cursors that disagree with ``assigned``).

Telemetry: ``snapshot.save`` / ``snapshot.restore`` spans plus the
``snapshot.count`` / ``snapshot.restore.count`` counters.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.state import STATE_VERSION, MatchState


class SnapshotMismatchError(RuntimeError):
    """The carried state does not belong to the run being resumed."""


class SnapshotCorruptError(RuntimeError):
    """The carried state is internally inconsistent."""


class SnapshotManager:
    """Commit/restore MatchState between epochs.

    ``directory`` is the snapshot root (one run per directory: snapshots
    are keyed by stream position, so mixing runs is exactly the mistake
    the fingerprint check exists to catch). ``keep`` and ``async_save``
    pass through to the underlying :class:`CheckpointManager`; async saves
    overlap the file IO with the next epoch's device work, and
    :meth:`wait` (called by restore and by the epoch executor before
    returning) joins the writer.
    """

    def __init__(
        self,
        directory: str,
        keep: int = 2,
        async_save: bool = True,
        telemetry=obs.DISABLED,
    ):
        self.manager = CheckpointManager(
            directory, keep=keep, async_save=async_save
        )
        self.telemetry = telemetry

    @property
    def directory(self) -> str:
        return self.manager.directory

    # -------------------------------------------------------------- save

    def save(self, state: MatchState) -> None:
        """Commit ``state`` keyed by its stream position.

        The position is the step number, so ``all_steps()`` reads as
        the list of stream positions that are safely on disk and
        ``latest()`` resumes from the furthest one.
        """
        with self.telemetry.span("snapshot.save", pos=state.pos):
            self.manager.save(
                state.pos, {"match_state": state.to_arrays()},
                metadata=state.metadata(),
            )
            self.telemetry.count("snapshot.count")

    def wait(self) -> None:
        """Join a pending async write (no-op when sync or idle)."""
        self.manager.wait()

    def all_positions(self) -> list[int]:
        """Stream positions with a committed snapshot, ascending."""
        return self.manager.all_steps()

    # ----------------------------------------------------------- restore

    def _manifest(self, pos: int) -> dict:
        path = os.path.join(
            self.directory, f"step_{pos:08d}", "manifest.json"
        )
        with open(path) as f:
            return json.load(f)

    def latest(
        self, template: MatchState, pos: Optional[int] = None
    ) -> Optional[MatchState]:
        """Load the latest (or given-position) snapshot for this run.

        ``template`` is the pos-0 :meth:`MatchState.initial` of the run
        being resumed: it supplies the expected fingerprint and array
        shapes. Returns ``None`` when the directory holds no committed
        snapshot (fresh start), raises :class:`SnapshotMismatchError` /
        :class:`SnapshotCorruptError` on validation failure.
        """
        with self.telemetry.span("snapshot.restore"):
            self.wait()
            pos = pos if pos is not None else self.manager.latest_step()
            if pos is None:
                return None
            meta = self._manifest(pos)
            if meta.get("state_version") != STATE_VERSION:
                raise SnapshotMismatchError(
                    f"snapshot at pos {pos} has state_version "
                    f"{meta.get('state_version')!r}, expected {STATE_VERSION}"
                )
            if meta.get("fingerprint") != template.fingerprint:
                raise SnapshotMismatchError(
                    f"snapshot at pos {pos} fingerprints "
                    f"{meta.get('fingerprint')!r}, run fingerprints "
                    f"{template.fingerprint!r}: another stream, config "
                    f"or storage layout"
                )
            _, trees = self.manager.restore(
                {"match_state": template.to_arrays()}, step=pos
            )
            state = MatchState.from_arrays(meta, trees["match_state"])
            problems = state.problems()
            if problems:
                raise SnapshotCorruptError(
                    f"snapshot at pos {pos} is inconsistent: "
                    + "; ".join(problems)
                )
            self.telemetry.count("snapshot.restore.count")
            return state
