"""Deadline / retry / straggler guard around device execution, the JAX
package's ``repro.core.executor`` on this package's telemetry.

The guard layer (:mod:`repro_torch.core.guard`) covers *data* faults and
the fallback ladder covers plan faults; this module covers *execution*
faults on a long chunked run: a flaky interconnect, a preempted device, a
hung collective. Policy:

* **transient** faults (``err.transient`` truthy, ``TimeoutError`` /
  ``ConnectionError`` / :class:`DeadlineExceededError`) are retried on
  the same engine with exponential backoff, up to ``retries`` times;
* **permanent** faults propagate at once: the engine call is expected to
  run with ``on_plan_failure="fallback"``, so anything that escapes it
  has already exhausted the degradation ladder, and validation or
  invariant errors would only recompute the same wrong answer;
* every epoch's wall time feeds the
  :class:`repro_torch.distributed.straggler.StragglerMonitor` EWMA: an
  epoch slower than ``threshold`` x the running mean emits a
  ``guard.straggler`` telemetry event.

The deadline is checked *post hoc*: work queued on the card cannot be
preempted from Python, so a blown deadline classifies the epoch as
transiently failed (and retries it) rather than interrupting it.

Injection seams for tests: ``clock`` (monotonic seconds) and ``sleep``;
:class:`repro_torch.testing.faultline.FakeClock` drives both, so backoff
schedules are asserted deterministically without real waiting.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch import obs


class DeadlineExceededError(RuntimeError):
    """An epoch ran past the guard's per-attempt deadline.

    Classified transient: the typical cause is a hung or contended
    device, and the retry re-dispatches the same work.
    """

    transient = True

    def __init__(self, seconds: float, deadline: float):
        self.seconds = seconds
        self.deadline = deadline
        super().__init__(
            f"epoch took {seconds:.3f}s, deadline {deadline:.3f}s"
        )


class RetriesExhaustedError(RuntimeError):
    """Transient failures persisted past the retry budget.

    ``attempts`` is the ordered list of exceptions, one per attempt, as
    :class:`repro_torch.kernels.substream_match.ops.FallbackExhaustedError`
    keeps them, so logs show the whole story.
    """

    def __init__(self, attempts):
        self.attempts = tuple(attempts)
        lines = "; ".join(
            f"attempt {i}: {type(e).__name__}: {e}"
            for i, e in enumerate(self.attempts)
        )
        super().__init__(f"retries exhausted ({lines})")


def is_transient(err: BaseException) -> bool:
    """Fault classification: retry-worthy or not.

    An explicit ``transient`` attribute wins either way (faultline's
    ``TransientFlake`` sets it true; a subclass could pin it false);
    otherwise OS-level timeout/connection errors default to transient
    and everything else to permanent.
    """
    flag = getattr(err, "transient", None)
    if flag is not None:
        return bool(flag)
    return isinstance(err, (TimeoutError, ConnectionError))


class ExecutionGuard:
    """Bounded-retry executor for one epoch-shaped unit of work.

    ``deadline`` is per attempt in seconds (``None`` = unbounded);
    ``retries`` is the number of *re*-tries after the first attempt;
    backoff before retry ``k`` (1-based) is ``backoff * backoff_factor
    ** (k - 1)`` seconds. ``monitor`` is an optional
    :class:`repro_torch.distributed.straggler.StragglerMonitor` fed with each
    successful attempt's duration.

    ``retry_log`` keeps ``(label, exception, slept_seconds)`` per retry
    for tests and post-mortems; ``guard.retry`` counts retries on the
    telemetry session and a ``guard.retry`` event names the cause.
    """

    def __init__(
        self,
        deadline: Optional[float] = None,
        retries: int = 2,
        backoff: float = 0.05,
        backoff_factor: float = 2.0,
        monitor=None,
        telemetry=obs.DISABLED,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.deadline = deadline
        self.retries = retries
        self.backoff = backoff
        self.backoff_factor = backoff_factor
        self.monitor = monitor
        self.telemetry = telemetry
        self.clock = clock
        self.sleep = sleep
        self.retry_log: list[tuple[str, BaseException, float]] = []

    def run(self, fn: Callable[[], object], label: str = "epoch"):
        """Run ``fn`` under the deadline/retry policy; returns its value.

        Raises :class:`RetriesExhaustedError` when transient failures
        outlast the budget, or the original exception unchanged when it
        is permanent. ``BaseException`` (incl. faultline's
        ``SimulatedCrash``) is never absorbed — a crash is a crash.
        """
        failures: list[BaseException] = []
        for attempt in range(self.retries + 1):
            start = self.clock()
            try:
                out = fn()
                elapsed = self.clock() - start
                if self.deadline is not None and elapsed > self.deadline:
                    raise DeadlineExceededError(elapsed, self.deadline)
            except Exception as err:  # noqa: BLE001 — classified below
                if not is_transient(err):
                    raise
                failures.append(err)
                if attempt == self.retries:
                    raise RetriesExhaustedError(failures) from err
                delay = self.backoff * self.backoff_factor**attempt
                self.telemetry.count("guard.retry")
                self.telemetry.event(
                    "guard.retry",
                    label=label,
                    attempt=attempt,
                    delay_seconds=delay,
                    reason=f"{type(err).__name__}: {err}"[:500],
                )
                self.retry_log.append((label, err, delay))
                self.sleep(delay)
                continue
            self._observe(label, elapsed)
            return out
        raise AssertionError("unreachable")  # pragma: no cover

    def _observe(self, label: str, elapsed: float) -> None:
        if self.monitor is None:
            return
        event = self.monitor.observe(elapsed)
        if event is not None:
            self.telemetry.count("guard.straggler")
            self.telemetry.event(
                "guard.straggler",
                label=label,
                step=event.step,
                seconds=event.step_time,
                ewma=event.ewma,
                ratio=event.ratio,
            )
