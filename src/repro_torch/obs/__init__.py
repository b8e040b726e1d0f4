"""Telemetry of the matching stack (no cost when disabled), the JAX
package's ``repro.obs`` on the port's engines.

Three parts:

* :mod:`repro_torch.obs.trace`: nesting span tracer on ``perf_counter``
  with Chrome trace-event JSON export (open in Perfetto), whose spans
  also open ``torch.profiler`` ranges while a profiler records;
* :mod:`repro_torch.obs.counters`: flat metrics registry for the plan and
  schedule quantities the engines already compute;
* :mod:`repro_torch.obs.report`: :class:`MatchTelemetry`, the per-call
  aggregate (stage split, counters, derived rate).

There are two ways to get the spans of the matching pipeline.

Run it under ``torch.profiler``, with nothing passed: the main path's
entries (``mwm_pipeline``, ``mwm_blocked``, ``substream_match``,
``merge_host``, ``merge_device``) resolve their ``telemetry`` through
:func:`active`, which, while the profiler records, hands them one
process-wide session (:func:`profiler_session`). Every span then lies in
the profiler's trace as a ``repro_torch/<name>`` range beside the kernels
and copies it launched, and stays readable in the session afterwards::

    with torch.profiler.profile(activities=[...CPU, ...CUDA]) as prof:
        mwm_pipeline(stream, cfg, part1="kernel")
    prof.export_chrome_trace("trace.json")        # spans and kernels, one clock
    obs.profiler_session().tracer.events          # the same spans, in memory

Or pass a session of your own::

    tel = obs.Telemetry()
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", telemetry=tel)
    print(tel.match_calls[-1].stage_seconds)     # schedule/pack/layout/...
    tel.write_chrome_trace("trace.json")          # -> ui.perfetto.dev

One ``pipeline`` span per ``mwm_pipeline`` call holds, on the card, the
stream's one ``stream.to``, ``blocked`` (``blocked.order``,
``blocked.permute``, Part 1's ``kernel_edges.*`` stages,
``blocked.unpermute``), ``merge.device`` (``merge.order``, then
``merge.greedy`` holding ``merge.kernel``, the merge's L = 1 launch),
``merge.d2h`` (the matched indices to the host) and ``merge.weight``; on
the CPU ``blocked`` (with its ``stream.to`` where it copies),
``merge.host`` (``merge.d2h``, ``merge.order``, ``merge.greedy``) and
``merge.weight``. Part 1's device stage (``kernel_edges.execute``, or
``.compile`` on the call that loads the library) carries ``edges``,
``bit_block_bytes`` and ``fits_l2``, as ``merge.kernel`` carries
``recorded`` and its own block's two.
Under an enabled session a span that launches device work synchronises
the device before it ends, so its length is its layer's time.

Every instrumented entry point takes ``telemetry=obs.DISABLED`` by
default. The disabled facade is one shared object whose ``span()``
returns one shared no-op context manager and whose counter calls do
nothing: engines call it unconditionally from hot paths without
allocating or branching beyond a method dispatch. With no profiler
recording, :func:`active` costs the entry one flag check.
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
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, profiling, stopwatch

__all__ = [
    "Telemetry",
    "DISABLED",
    "active",
    "profiler_session",
    "profiling",
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
        self.pipeline_calls = 0

    def span(self, name: str, sync=None, **args):
        """Nesting span context manager (recorded on exit); ``sync``, a
        device synchronised before the span ends when it is a CUDA one."""
        return self.tracer.span(name, sync, **args)

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

    def span(self, name, sync=None, **args):
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


_PROFILER_SESSION: Telemetry | None = None


def profiler_session() -> Telemetry:
    """The process-wide session that entries record into while a
    ``torch.profiler`` records and they were passed no enabled session
    (made at the first call; read it after the profiler's window)."""
    global _PROFILER_SESSION
    if _PROFILER_SESSION is None:
        _PROFILER_SESSION = Telemetry()
    return _PROFILER_SESSION


def active(telemetry):
    """The session an entry records into: ``telemetry`` when it is
    enabled; otherwise :func:`profiler_session` while a profiler records,
    and :data:`DISABLED` when none does (one flag check)."""
    if telemetry is not None and telemetry.enabled:
        return telemetry
    if profiling():
        return profiler_session()
    return DISABLED
