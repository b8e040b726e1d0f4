"""Per-call telemetry records of the matching engines.

A :class:`MatchTelemetry` is the aggregate of ONE ``substream_match``
(or plain-engine) call: which engine and backend ran, the host stage
split, the counter snapshot, and the derived rate. The stages:

``schedule``
    Host wave-schedule assignment, or, when a precomputed schedule was
    passed in, its validation.
``pack``
    Host fill-packed slot layout of a schedule built in-call (0.0 when
    the schedule was precomputed).
``layout``
    Per-call operand prep: the kernel's operands on the card (slot
    arrays, thresholds, padded carried bits) and the slot → stream
    scatter-back.
``compile``
    Wall time of the device call that built or loaded the kernel's
    library in this process (``nvcc`` and ``dlopen``, plus the first
    launch); 0 on every later call.
``execute``
    Wall time of the device call up to ``torch.cuda.synchronize`` on
    every call after that, and of the plain versions on the CPU.

Stage seconds are disjoint wall-clock intervals of the same call, so
``sum(stage_seconds.values()) <= wall_seconds`` always, as
:func:`consistency_problems` checks.

Engines build records through :func:`recorder`; its disabled twin
(:data:`NULL_RECORDER`) makes every instrumentation site a no-op when
telemetry is off.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.obs.trace import NULL_SPAN, close_range, open_range

#: The stage keys, in pipeline order. Every MatchTelemetry carries exactly these.
STAGES = ("schedule", "pack", "layout", "compile", "execute")

#: Counter names every wave/mega engine record carries (the plan
#: accounting that tests compare bit-exactly with a recomputed plan).
PLAN_COUNTERS = ("plan.gather_bytes", "plan.bit_block_bytes")


@dataclasses.dataclass(frozen=True)
class MatchTelemetry:
    """Aggregated telemetry of one matching-engine call.

    ``backend`` is ``"cuda"`` or ``"cpu"``; ``interpret`` (the JAX
    package's name for its interpret-mode kernels, kept so that
    :meth:`asdict` has the same keys) is true exactly when the kernels'
    plain versions ran.
    """

    engine: str
    backend: str
    interpret: bool
    num_edges: int
    wall_seconds: float
    stage_seconds: dict
    counters: dict

    @property
    def edges_per_sec(self) -> float:
        """Full-call rate (host + device)."""
        return self.num_edges / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def device_seconds(self) -> float:
        return self.stage_seconds.get("compile", 0.0) + self.stage_seconds.get(
            "execute", 0.0
        )

    def asdict(self) -> dict:
        """JSON-ready dict (stages in canonical order, sorted counters)."""
        return {
            "engine": self.engine,
            "backend": self.backend,
            "interpret": self.interpret,
            "num_edges": self.num_edges,
            "wall_seconds": self.wall_seconds,
            "edges_per_sec": self.edges_per_sec,
            "stage_seconds": {s: self.stage_seconds.get(s, 0.0) for s in STAGES},
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
        }


def consistency_problems(
    stage_seconds: dict, wall_seconds: float, rel_slack: float = 0.02,
    abs_slack: float = 1e-4,
) -> list[str]:
    """Internal-consistency check of a record's stage split.

    Returns human-readable problem strings (empty = consistent): missing
    stage keys, negative stages, or stage sums exceeding the call's wall
    time beyond slack (stages are disjoint sub-intervals of the wall
    interval, so their sum can never legitimately exceed it).
    """
    problems = []
    missing = [s for s in STAGES if s not in stage_seconds]
    if missing:
        problems.append(f"missing stage keys {missing}")
    negative = {s: v for s, v in stage_seconds.items() if v < 0}
    if negative:
        problems.append(f"negative stage seconds {negative}")
    total = sum(v for v in stage_seconds.values() if v > 0)
    if total > wall_seconds * (1 + rel_slack) + abs_slack:
        problems.append(
            f"stage sum {total:.6f}s exceeds wall {wall_seconds:.6f}s"
        )
    return problems


class _StageSpan:
    """Context manager crediting its duration to one recorder stage (and,
    while the profiler records, a ``record_function`` range of its span);
    ``args`` go out with the stage's span."""

    __slots__ = ("_rec", "_stage", "_name", "_args", "_t0", "_range")

    def __init__(self, rec: "MatchRecorder", stage: str, args: dict | None = None):
        self._rec = rec
        self._stage = stage
        self._name = f"{rec.engine}.{stage}"
        self._args = args

    def __enter__(self):
        self._range = open_range(self._name)
        self._t0 = time.perf_counter()
        return self

    def note(self, **args):
        """Add ``args`` to the stage span's (known only inside it)."""
        self._args = {**(self._args or {}), **args}

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        rec = self._rec
        rec.stage_seconds[self._stage] += t1 - self._t0
        rec._telemetry.tracer.complete(self._name, self._t0, t1, self._args)
        close_range(self._range)
        return False


def _library_loaded(library) -> bool:
    from repro_torch.kernels import build

    return library is None or library in build.loaded()


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _tensors(item)


class MatchRecorder:
    """Accumulates one engine call's stages/counters into a record.

    Created via :func:`recorder` at engine entry; ``finish()`` seals the
    record, appends it to ``telemetry.match_calls``, and folds the
    session-level aggregates (call counts, library hit/miss totals) into
    the telemetry counter registry.
    """

    __slots__ = (
        "_telemetry", "engine", "backend", "interpret", "num_edges",
        "stage_seconds", "counters", "_t0",
    )

    def __init__(self, telemetry, engine, num_edges, backend, interpret):
        self._telemetry = telemetry
        self.engine = engine
        self.backend = backend
        self.interpret = interpret
        self.num_edges = num_edges
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self.counters: dict = {}
        self._t0 = time.perf_counter()

    def stage(self, name: str, **args) -> _StageSpan:
        """``with rec.stage("layout"): ...``: credit the block to a stage;
        ``args`` are the stage span's."""
        return _StageSpan(self, name, args or None)

    def device_stage(self, library=None, **args) -> _StageSpan:
        """Stage of the device call: ``compile`` when it will build or load
        the kernel library ``library`` (:data:`repro_torch.kernels.build`
        keeps what this process loaded), ``execute`` otherwise (and always
        for ``library=None``: the plain versions build nothing). Counts
        ``jit.variant_miss`` or ``jit.variant_hit`` (the JAX package's
        names for its compile cache) to match. ``args`` are the span's."""
        hit = _library_loaded(library)
        self.count("jit.variant_hit" if hit else "jit.variant_miss")
        return self.stage("execute" if hit else "compile", **args)

    def add_stage(self, name: str, seconds: float):
        """Credit pre-measured seconds to a stage (the schedule and pack
        timings a :class:`~repro_torch.graph.waves.WaveSchedule` carries)."""
        self.stage_seconds[name] += seconds

    def count(self, name: str, value=1):
        self.counters[name] = self.counters.get(name, 0) + value

    def put(self, name: str, value):
        self.counters[name] = value

    def put_many(self, values: dict, prefix: str = ""):
        for k, v in values.items():
            self.counters[prefix + k] = v

    def block(self, out):
        """``torch.cuda.synchronize`` on the card the tensors of ``out`` lie
        on, so their device time lands in the open stage; only ever called
        on the enabled path."""
        for t in _tensors(out):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
                break
        return out

    def finish(self) -> MatchTelemetry:
        wall = time.perf_counter() - self._t0
        record = MatchTelemetry(
            engine=self.engine,
            backend=self.backend,
            interpret=self.interpret,
            num_edges=self.num_edges,
            wall_seconds=wall,
            stage_seconds=dict(self.stage_seconds),
            counters=dict(self.counters),
        )
        tel = self._telemetry
        tel.match_calls.append(record)
        tel.counters.add("substream_match.calls")
        tel.counters.add("jit.variant_hits", self.counters.get("jit.variant_hit", 0))
        tel.counters.add(
            "jit.variant_misses", self.counters.get("jit.variant_miss", 0)
        )
        tel.counters.update(record.counters, prefix=f"{self.engine}.")
        return record


class _NullRecorder:
    """Shared no-op recorder: the entire disabled instrumentation path."""

    __slots__ = ()

    def stage(self, name, **args):
        return NULL_SPAN

    def device_stage(self, library=None, **args):
        return NULL_SPAN

    def add_stage(self, name, seconds):
        pass

    def count(self, name, value=1):
        pass

    def put(self, name, value):
        pass

    def put_many(self, values, prefix=""):
        pass

    def block(self, out):
        return out

    def finish(self):
        return None


NULL_RECORDER = _NullRecorder()


def recorder(
    telemetry, engine: str, num_edges: int, backend: str = "", interpret: bool = False
):
    """A :class:`MatchRecorder` when telemetry is enabled, else the shared
    no-op recorder. The single entry engines instrument through."""
    if telemetry is None or not telemetry.enabled:
        return NULL_RECORDER
    return MatchRecorder(telemetry, engine, num_edges, backend, interpret)
