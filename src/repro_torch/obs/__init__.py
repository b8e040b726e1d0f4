"""Telemetry of the matching stack (no cost when disabled), the JAX
package's ``repro.obs`` on the port's engines.

Three parts:

* :mod:`repro_torch.obs.trace`: nesting span tracer on ``perf_counter``
  with Chrome trace-event JSON export (open in Perfetto);
* :mod:`repro_torch.obs.counters`: flat metrics registry for the plan and
  schedule quantities the engines already compute;
* :mod:`repro_torch.obs.report`: :class:`MatchTelemetry`, the per-call
  aggregate (stage split, counters, derived rates, roofline fraction).

Usage::

    from repro_torch import obs

    tel = obs.Telemetry()
    result = substream_match(stream, cfg, schedule="mega", telemetry=tel)
    print(tel.match_calls[-1].stage_seconds)     # schedule/pack/layout/...
    tel.write_chrome_trace("trace.json")          # -> ui.perfetto.dev

Every instrumented entry point takes ``telemetry=obs.DISABLED`` by
default. The disabled facade is one shared object whose ``span()``
returns one shared no-op context manager and whose counter calls do
nothing: engines call it unconditionally from hot paths without
allocating or branching beyond a method dispatch.
"""
from __future__ import annotations

from repro_torch.obs.counters import NULL_COUNTERS, Counters, variant_seen
from repro_torch.obs.report import (
    PLAN_COUNTERS,
    STAGES,
    MatchTelemetry,
    NULL_RECORDER,
    consistency_problems,
    recorder,
)
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, stopwatch

__all__ = [
    "Telemetry",
    "DISABLED",
    "Tracer",
    "Span",
    "Counters",
    "MatchTelemetry",
    "STAGES",
    "PLAN_COUNTERS",
    "stopwatch",
    "recorder",
    "consistency_problems",
    "variant_seen",
    "NULL_SPAN",
    "NULL_COUNTERS",
    "NULL_RECORDER",
]


class Telemetry:
    """Enabled telemetry session: one tracer + one counter registry.

    ``match_calls`` collects the :class:`MatchTelemetry` record of every
    instrumented engine call made with this session; ``events`` holds
    the structured instant events (e.g. ``substream_match.backend``)
    in arrival order, mirrored into the trace as instant marks.
    """

    enabled = True

    def __init__(self):
        self.tracer = Tracer()
        self.counters = Counters()
        self.match_calls: list[MatchTelemetry] = []
        self.events: list[dict] = []

    def span(self, name: str, **args):
        """Nesting span context manager (recorded on exit)."""
        return self.tracer.span(name, **args)

    def count(self, name: str, value=1):
        self.counters.add(name, value)

    def event(self, name: str, **args):
        """Structured instant event: kept in ``events`` + the trace."""
        self.events.append({"name": name, **args})
        self.tracer.instant(name, **args)

    def chrome_trace(self) -> dict:
        return self.tracer.chrome_trace(metadata={"counters": self.counters.asdict()})

    def write_chrome_trace(self, path) -> None:
        """Write the session trace to ``path`` (Chrome trace-event JSON)."""
        self.tracer.write_chrome_trace(
            path, metadata={"counters": self.counters.asdict()}
        )


class _DisabledTelemetry:
    """The shared no-op telemetry facade (:data:`DISABLED`).

    Identity-stable: ``DISABLED.span(...)`` returns the one module-level
    :data:`NULL_SPAN` object every time, counters route to
    :data:`NULL_COUNTERS`, and nothing is ever recorded. ``match_calls``
    and ``events`` are shared empty tuples so accidental reads are safe
    and accidental writes fail loudly.
    """

    enabled = False
    counters = NULL_COUNTERS
    match_calls = ()
    events = ()

    __slots__ = ()

    def span(self, name, **args):
        return NULL_SPAN

    def count(self, name, value=1):
        pass

    def event(self, name, **args):
        pass

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        raise RuntimeError(
            "telemetry is disabled; construct repro_torch.obs.Telemetry() and pass "
            "it via telemetry= to record a trace"
        )


DISABLED = _DisabledTelemetry()
