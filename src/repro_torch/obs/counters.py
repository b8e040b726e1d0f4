"""Metrics registry: the quantities the plans compute, kept.

A :class:`Counters` is a flat name → number registry with two write
modes: :meth:`add` accumulates (call counts, bytes moved) and :meth:`put`
overwrites (gauges: fill, plan geometry). Names are dotted and lowercase,
the JAX package's catalog: ``schedule.num_waves``, ``plan.gather_bytes``,
``jit.variant_misses``.

Values are plain Python ints/floats copied bit-exactly from their
sources (the ``WavePlan`` accounting, ``WaveSchedule`` geometry), so
tests can compare them ``==`` against a recomputed plan: the registry
never rounds or rescales.

The disabled path is :data:`NULL_COUNTERS`, a shared no-op instance;
like the null span it allocates nothing per call.

:func:`variant_seen` is a process-wide ledger of keys seen once, the JAX
package's jit-variant ledger. The port's engines label their device stage
by whether the call loaded a kernel library instead
(:meth:`repro_torch.obs.report.MatchRecorder.device_stage`).
"""
from __future__ import annotations


class Counters:
    """Flat metrics registry: dotted names → int/float values."""

    __slots__ = ("_vals",)

    def __init__(self):
        self._vals: dict[str, float] = {}

    def add(self, name: str, value=1):
        """Accumulate ``value`` onto ``name`` (missing counters start at 0)."""
        self._vals[name] = self._vals.get(name, 0) + value

    def put(self, name: str, value):
        """Set gauge ``name`` to exactly ``value`` (overwrites)."""
        self._vals[name] = value

    def get(self, name: str, default=0):
        return self._vals.get(name, default)

    def update(self, other: dict, prefix: str = ""):
        """Bulk :meth:`put` from a dict, optionally under ``prefix``."""
        for k, v in other.items():
            self._vals[prefix + k] = v

    def asdict(self) -> dict:
        """Plain sorted dict copy (JSON-ready)."""
        return {k: self._vals[k] for k in sorted(self._vals)}

    def __len__(self) -> int:
        return len(self._vals)

    def __repr__(self) -> str:
        return f"Counters({self._vals!r})"


class _NullCounters:
    """Shared no-op registry for the disabled path."""

    __slots__ = ()

    def add(self, name, value=1):
        pass

    def put(self, name, value):
        pass

    def get(self, name, default=0):
        return default

    def update(self, other, prefix=""):
        pass

    def asdict(self) -> dict:
        return {}

    def __len__(self) -> int:
        return 0


NULL_COUNTERS = _NullCounters()

#: Process-wide set of keys already seen once.
_VARIANTS_SEEN: set = set()


def variant_seen(key) -> bool:
    """True if ``key`` was seen before in this process (a cache hit).

    The first call for a key returns False and marks it seen. Tracked
    whether telemetry is on or off, so hit/miss labels stay truthful
    across enable/disable boundaries.
    """
    if key in _VARIANTS_SEEN:
        return True
    _VARIANTS_SEEN.add(key)
    return False
