"""The program's own spans, read after the window from the session that
``repro_torch.obs`` records into while a ``torch.profiler`` records
(``obs.profiler_session()``): a traced run fills it with no edit to the
benchmark. Where the program has no such session (an older program), or
it holds no ``pipeline`` span, the readers find nothing."""
from __future__ import annotations

import bisect


def session_events():
    """The complete events of the program's profiler session, or None."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    session = getattr(obs, "profiler_session", None)
    if session is None:
        return None
    return [e for e in session().tracer.events if e.get("ph") == "X"]


def per_job_ms(record, name: str, keep=None, events=None):
    """Total length of the spans ``name`` (those whose args ``keep``
    accepts) inside this run's ``pipeline`` spans, over their number, in
    ms. This run's pipelines are the session's last ``len(record["jobs"])``
    (one a job; a session outlives a run in one process). None without a
    session, a job or a ``pipeline`` span."""
    events = session_events() if events is None else events
    jobs = len(record.get("jobs") or ())
    if not events or not jobs:
        return None
    pipes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "pipeline")
    pipes = pipes[-jobs:]
    if not pipes:
        return None
    starts = [a for a, _ in pipes]
    total = 0.0
    for e in events:
        if e["name"] != name or (keep is not None and not keep(e.get("args") or {})):
            continue
        k = bisect.bisect_right(starts, e["ts"]) - 1
        if k >= 0 and e["ts"] + e["dur"] <= pipes[k][1]:
            total += e["dur"]
    return total / len(pipes) * 1e-3
