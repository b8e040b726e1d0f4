"""Nesting span tracer with Chrome trace-event JSON export.

The tracer is the timing half of :mod:`repro_torch.obs`: ``with
tracer.span("pack"): ...`` records one *complete* event per exit on a
single ``perf_counter`` timebase, and :meth:`Tracer.chrome_trace`
serializes the session as Chrome trace-event JSON — the format Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` open directly.
Nesting is positional, exactly like Chrome's own traces: an event is a
child of whichever event's ``[ts, ts + dur]`` interval encloses it on
the same track, so the tracer needs no explicit stack.

On the profiler's clock
-----------------------
While a ``torch.profiler`` records (:func:`profiling`), every span of an
enabled session (:class:`Span`, the recorder's stages, :class:`stopwatch`)
also opens ``torch.profiler.record_function("repro_torch/<name>")`` for
its length: the profiler's trace then holds the span as a
``user_annotation`` event on the same clock as the device's kernels and
copies. The range is opened only after that one flag check says yes: an
empty ``record_function`` costs tens of times the check even with no
profiler running.
A span opened with ``sync=<device>`` synchronises that device (when it is
a CUDA device) before it ends, so that its length is its device work's.

Zero-overhead-when-disabled contract
------------------------------------
The disabled path never touches this module's classes: ``NULL_SPAN`` is
one shared, reentrant no-op context manager and the disabled telemetry
facade returns it by identity from every ``span()`` call — no event
list, no timestamping, no per-call object. Hot loops may call
``telemetry.span(...)`` unconditionally.

:class:`stopwatch` is the single timing path shared by code that must
report a duration even when telemetry is off (e.g. the deprecated
``WaveSchedule.schedule_seconds`` compatibility fields): it always
measures ``perf_counter`` and *additionally* records a span when the
telemetry object is enabled, so there is one measurement, two views.
"""
from __future__ import annotations

import json
import threading
import time

import torch

#: prefix of the profiler ranges the spans open
PROFILER_PREFIX = "repro_torch/"

#: True while a ``torch.profiler`` records on this process
profiling = torch._C._autograd._profiler_enabled


def open_range(name: str):
    """The ``record_function`` range of span ``name``, entered, while the
    profiler records; None (nothing opened) when it does not."""
    if not profiling():
        return None
    rf = torch.profiler.record_function(PROFILER_PREFIX + name)
    rf.__enter__()
    return rf


def close_range(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


def synchronize(device) -> None:
    """``torch.cuda.synchronize`` on ``device`` (a device, its name or a
    tensor on it) when it is a CUDA device; nothing otherwise."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _NullSpan:
    """Shared no-op context manager — the entire disabled span path.

    A single module-level instance (:data:`NULL_SPAN`) is returned for
    every disabled ``span()`` call; it is stateless, reentrant, and
    allocation-free on entry/exit.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args):
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One live span of an enabled :class:`Tracer` (context manager).

    Timestamps are taken on ``__enter__``/``__exit__``; the completed
    event is appended to the owning tracer at exit. ``seconds`` holds
    the duration after exit (also exposed by :class:`stopwatch`).
    ``sync`` names a device synchronised before the span ends (a clean
    exit only); :meth:`note` adds args known only inside the span.
    """

    __slots__ = ("_tracer", "name", "args", "sync", "t0", "seconds", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None, sync=None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.sync = sync
        self.t0 = 0.0
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "Span":
        self._range = open_range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if self.sync is not None and exc_type is None:
            synchronize(self.sync)
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        self._tracer.complete(self.name, self.t0, t1, self.args)
        close_range(self._range)
        return False

    def note(self, **args):
        """Add ``args`` to the span's (they are exported with it)."""
        self.args = {**(self.args or {}), **args}


class Tracer:
    """Collects spans + instants and exports Chrome trace-event JSON.

    All timestamps are ``perf_counter`` seconds relative to the
    tracer's construction (``epoch``), exported as microseconds — the
    trace-event ``ts`` unit. One tracer = one trace file.
    """

    def __init__(self):
        self.epoch = time.perf_counter()
        self.events: list[dict] = []
        self._tids: dict[int, int] = {}

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def span(self, name: str, sync=None, **args) -> Span:
        """``with tracer.span("pack"): ...`` — records one complete event."""
        return Span(self, name, args or None, sync)

    def complete(self, name: str, t0: float, t1: float, args: dict | None = None):
        """Record an already-measured span (the :class:`stopwatch` path)."""
        ev = {
            "name": name,
            "cat": "obs",
            "ph": "X",
            "ts": (t0 - self.epoch) * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": 0,
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, **args):
        """Record a zero-duration (instant) event — structured telemetry."""
        ev = {
            "name": name,
            "cat": "obs",
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter() - self.epoch) * 1e6,
            "pid": 0,
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def chrome_trace(self, metadata: dict | None = None) -> dict:
        """The session as a Chrome trace-event JSON object (dict)."""
        trace = {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
        }
        if metadata:
            trace["otherData"] = dict(metadata)
        return trace

    def write_chrome_trace(self, path, metadata: dict | None = None) -> None:
        """Write the trace to ``path`` — open it at https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(metadata), f)
            f.write("\n")


class stopwatch:
    """Measure a block's wall seconds AND record a telemetry span.

    The one timing path for durations that must exist even when
    telemetry is disabled (the ``WaveSchedule.schedule_seconds`` /
    ``pack_seconds`` compatibility fields): ``perf_counter`` is always
    read, ``seconds`` is always set, and the span is recorded into the
    telemetry object's tracer only when it is enabled — one
    measurement, never two timing code paths.
    """

    __slots__ = ("_telemetry", "_name", "_args", "t0", "seconds", "_range")

    def __init__(self, telemetry, name: str, **args):
        self._telemetry = telemetry
        self._name = name
        self._args = args or None
        self.t0 = 0.0
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "stopwatch":
        tel = self._telemetry
        if tel is not None and tel.enabled:
            self._range = open_range(self._name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        tel = self._telemetry
        if tel is not None and tel.enabled:
            tel.tracer.complete(self._name, self.t0, t1, self._args)
        close_range(self._range)
        return False
