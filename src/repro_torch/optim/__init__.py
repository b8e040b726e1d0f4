"""The optimizer of the port: the JAX package's AdamW (as a
``torch.optim.Optimizer``), its LR schedules and int8 gradient
compression."""
from repro_torch.optim.adamw import (
    AdamW,
    AdamWConfig,
    adamw_init,
    adamw_init_specs,
    clip_by_global_norm,
)
from repro_torch.optim.compression import ErrorFeedback, compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule

__all__ = [
    "AdamW",
    "AdamWConfig",
    "adamw_init",
    "adamw_init_specs",
    "clip_by_global_norm",
    "wsd_schedule",
    "cosine_schedule",
    "compress_int8",
    "decompress_int8",
    "ErrorFeedback",
]
