"""Resume support: the structured errors of a carried state that does not
belong to, or does not hold together for, the run it is handed to."""
from repro_torch.checkpoint.snapshots import SnapshotCorruptError, SnapshotMismatchError

__all__ = ["SnapshotCorruptError", "SnapshotMismatchError"]
