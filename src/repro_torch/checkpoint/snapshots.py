"""Structured errors of a carried :class:`repro_torch.core.state.MatchState`.

* :class:`SnapshotMismatchError`: the state belongs to a different
  (stream, config, storage) triple; resuming would compute a wrong
  matching, so this is always an error, never a silent fresh start.
* :class:`SnapshotCorruptError`: the state is internally inconsistent
  (torn arrays, recorded-count cursors that disagree with ``assigned``).

The snapshot manager that commits states to disk is not ported yet
(ROADMAP.md §1 item 10).
"""
from __future__ import annotations


class SnapshotMismatchError(RuntimeError):
    """The carried state does not belong to the run being resumed."""


class SnapshotCorruptError(RuntimeError):
    """The carried state is internally inconsistent."""
