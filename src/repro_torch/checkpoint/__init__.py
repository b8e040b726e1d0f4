"""Crash-safe checkpoints of the port: the numpy checkpoint manager, the
:class:`~repro_torch.core.state.MatchState` snapshots of the epoch
executor, and their structured errors. The layout on disk is the JAX
package's."""
from repro_torch.checkpoint.manager import CheckpointManager, load_pytree, save_pytree
from repro_torch.checkpoint.snapshots import (
    SnapshotCorruptError,
    SnapshotManager,
    SnapshotMismatchError,
)

__all__ = [
    "CheckpointManager",
    "save_pytree",
    "load_pytree",
    "SnapshotManager",
    "SnapshotMismatchError",
    "SnapshotCorruptError",
]
