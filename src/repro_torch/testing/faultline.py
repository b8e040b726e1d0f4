"""Deterministic fault injection for the guarded matching pipeline, the
JAX package's ``repro.testing.faultline`` on this package's streams.

Test machinery that manufactures the failure modes the guard layer
(:mod:`repro_torch.core.guard`), the fallback ladder
(``substream_match(..., on_plan_failure="fallback")``) and the resumable
executor claim to handle:

* **input faults**: :func:`poison_ids` / :func:`poison_weights` plant
  out-of-range ids (including the sacrificial padding row ``n_pad``) and
  NaN/Inf/negative weights at chosen stream positions;
* **result corruptions**: :func:`corrupt_assigned` rewrites ``assigned``
  entries, :func:`flip_matching_bit` flips one bit of the (packed or
  dense) bit block;
* **schedule faults**: :func:`truncate_schedule` / :func:`permute_schedule`
  produce the stale or corrupted precomputed schedules
  ``repro_torch.graph.waves.validate_schedule`` exists to reject;
* **plan and launch faults**: :func:`failing` patches the named ``ops``
  internals (planners or the device seams) to raise, forcing the ladder
  to degrade;
* **execution faults**: :class:`SimulatedCrash`, :class:`TransientFlake`,
  :func:`kill_at_epoch`, :func:`kill_mid_snapshot`, :class:`FakeClock`.

Everything is deterministic: no RNG, no wall clock; the same call always
injects the same fault, so a failing test replays exactly. The injected
streams and results lie on the device of the ones they were made from.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core.types import EdgeStream, MatchingResult, to_numpy


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """What was planted: the guard taxonomy ``kind`` expected to flag it,
    the stream positions touched, and a human-readable description."""

    kind: str
    positions: tuple
    description: str


def _replace(stream: EdgeStream, **arrays) -> EdgeStream:
    fields = {k: to_numpy(getattr(stream, k)).copy() for k in ("src", "dst", "weight", "valid")}
    fields.update(arrays)
    return EdgeStream(**{k: torch.from_numpy(v).to(stream.device) for k, v in fields.items()})


def sacrificial_row(n: int) -> int:
    """The padding row id the row-addressed kernels scatter padding slots
    to (``device_plan``'s ``n_pad``), an id a dirty input could collide
    with. Mirrors ``ops.device_plan``'s rounding so the injector does not
    import the module it is used to break."""
    return ((max(n, 1) + 7) // 8) * 8


def poison_ids(
    stream: EdgeStream, n: int, positions, mode: str = "past_n"
) -> tuple[EdgeStream, InjectedFault]:
    """Plant out-of-range vertex ids at the given stream positions.

    ``mode``: ``"past_n"`` (id = n, one past the last vertex),
    ``"sacrificial"`` (id = the kernels' padding row ``n_pad``),
    ``"negative"`` (id = -1), ``"int_max"`` (id = 2**31 - 1).
    """
    values = {
        "past_n": n,
        "sacrificial": sacrificial_row(n),
        "negative": -1,
        "int_max": np.iinfo(np.int32).max,
    }
    if mode not in values:
        raise ValueError(f"unknown mode {mode!r}; use one of {sorted(values)}")
    pos = tuple(int(p) for p in positions)
    src = to_numpy(stream.src).copy()
    src[list(pos)] = np.int32(values[mode])
    return (
        _replace(stream, src=src),
        InjectedFault(
            kind="id_out_of_range",
            positions=pos,
            description=f"src id -> {values[mode]} ({mode}) at {list(pos)}",
        ),
    )


def poison_weights(
    stream: EdgeStream, positions, mode: str = "nan"
) -> tuple[EdgeStream, InjectedFault]:
    """Plant dirty weights: ``"nan"``, ``"posinf"``, ``"neginf"``, or
    ``"negative"`` (finite w = -1.5)."""
    values = {
        "nan": np.nan,
        "posinf": np.inf,
        "neginf": -np.inf,
        "negative": -1.5,
    }
    if mode not in values:
        raise ValueError(f"unknown mode {mode!r}; use one of {sorted(values)}")
    pos = tuple(int(p) for p in positions)
    w = to_numpy(stream.weight).copy()
    w[list(pos)] = np.float32(values[mode])
    kind = "negative_weight" if mode == "negative" else "nonfinite_weight"
    return (
        _replace(stream, weight=w),
        InjectedFault(
            kind=kind,
            positions=pos,
            description=f"weight -> {values[mode]} at {list(pos)}",
        ),
    )


# ---------------------------------------------------------------------------
# Result corruptions (for check_matching)
# ---------------------------------------------------------------------------


def corrupt_assigned(result: MatchingResult, position: int, value: int) -> MatchingResult:
    """Rewrite ``assigned[position] = value``, keeping the bit storage.

    Depending on ``value`` and the stream this manufactures an
    out-of-range substream, an ineligible/padding/self-loop record, or a
    duplicate per-substream match — the test picks the scenario."""
    assigned = result.assigned.clone()
    assigned[int(position)] = int(value)
    return result.with_assigned(assigned)


def flip_matching_bit(result: MatchingResult, vertex: int, substream: int) -> MatchingResult:
    """Flip one matching bit ``mb[vertex, substream]`` in the result's own
    storage — XORing the byte of the packed bit-plane block when the
    result is packed, the bool entry when dense."""
    if result.is_packed:
        mbp = result.mb_packed.clone()
        mbp[int(vertex), int(substream) // 8] ^= 1 << (int(substream) % 8)
        return MatchingResult(assigned=result.assigned, mb_packed=mbp, L=result.L)
    mb = result.mb.clone()
    mb[int(vertex), int(substream)] ^= True
    return MatchingResult(assigned=result.assigned, mb=mb)


def repacked(result: MatchingResult) -> MatchingResult:
    """The same result in packed storage (identity if already packed): lets
    bit-plane corruption tests cover the packed path explicitly."""
    if result.is_packed:
        return result
    return MatchingResult(
        assigned=result.assigned, mb_packed=bitpack.pack_bits(result.mb), L=result.L
    )


# ---------------------------------------------------------------------------
# Schedule faults (for validate_schedule / the cascade)
# ---------------------------------------------------------------------------


def truncate_schedule(schedule):
    """Drop the last segment row of the slot layout — the shape of a stale
    schedule persisted for a shorter stream. ``validate_schedule`` must
    reject it (slot layout no longer agrees with the wave order)."""
    if schedule.num_segments == 0:
        raise ValueError("cannot truncate an empty schedule")
    return dataclasses.replace(schedule, slots=schedule.slots[:-1].copy())


def duplicate_order_entry(schedule):
    """Schedule the first edge twice (replacing the last scheduled edge,
    consistently in ``order`` AND the slot layout). When the two copies
    land in different waves this passes the coverage, slot-agreement and
    per-wave disjointness checks — only the order-is-a-permutation check
    rejects it."""
    if schedule.num_scheduled < 2:
        raise ValueError("need >= 2 scheduled edges to duplicate one")
    order = schedule.order.copy()
    slots = schedule.slots.copy()
    flat = slots.reshape(-1)
    pos = np.flatnonzero(flat >= 0)
    order[-1] = order[0]
    flat[pos[-1]] = order[0]
    return dataclasses.replace(
        schedule, order=order, slots=flat.reshape(slots.shape)
    )


def permute_schedule(schedule):
    """Reverse the wave-major order while keeping the slot layout — the
    shape of a schedule whose derived fields drifted after a stream
    permutation. ``validate_schedule`` must reject it (requires >= 2
    scheduled edges to be an actual corruption)."""
    if schedule.num_scheduled < 2:
        raise ValueError("permuting < 2 scheduled edges is a no-op")
    return dataclasses.replace(schedule, order=schedule.order[::-1].copy())


# ---------------------------------------------------------------------------
# Plan / launch fault forcing (for the fallback ladder)
# ---------------------------------------------------------------------------


class InjectedFailure(RuntimeError):
    """The exception :func:`failing` raises from patched internals."""


#: Patchable internals, by the JAX package's short target names: the
#: planners and the device seams of ``ops``, and the plain engines of
#: ``core.matching``. The *module attributes* are patched (the entries
#: look them up at call time). ``vmem_plan`` is the port's
#: ``device_plan``, which the wave plans call too.
_TARGETS = {
    "vmem_plan": "device_plan",
    "wave_plan": "wave_plan",
    "mega_plan": "mega_plan",
    "edges_device": "_edges_device",
    "waves_device": "_waves_device",
    "mega_device": "_mega_device",
    "scan_oracle": "mwm_scan",
    "waves_xla": "mwm_waves",
}
#: Seams patched with a target besides its own: the per-edge engine's launch
#: is the walker's or, on the card, the rounds engine's.
_ALSO = {"edges_device": ("_rounds_device",)}


@contextlib.contextmanager
def failing(*targets: str, exc_type=InjectedFailure):
    """Force the named ops/matching internals to raise inside the block.

    ``targets`` are keys of :data:`_TARGETS`: planners (``vmem_plan``,
    ``wave_plan``, ``mega_plan``), device seams (``edges_device``,
    ``waves_device``, ``mega_device``), or the plain engines
    (``waves_xla``, ``scan_oracle``). Always restores the originals, even
    when the block raises."""
    from repro_torch.core import matching as _matching
    from repro_torch.kernels.substream_match import ops as _ops

    unknown = [t for t in targets if t not in _TARGETS]
    if unknown:
        raise ValueError(f"unknown targets {unknown}; use {sorted(_TARGETS)}")

    def _raiser(name):
        def _fail(*args, **kwargs):
            raise exc_type(f"injected failure in {name}")

        return _fail

    saved = []
    try:
        for t in targets:
            module = _matching if t in ("scan_oracle", "waves_xla") else _ops
            for attr in (_TARGETS[t], *_ALSO.get(t, ())):
                saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, _raiser(t))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


# --------------------------------------------------------------------------
# Execution faults (crashes, hangs, flakes) for the resumable executor.


class SimulatedCrash(BaseException):
    """A process death, not an error: derives from ``BaseException`` so no
    ``except Exception`` in the pipeline (the fallback ladder, the
    ExecutionGuard) can absorb it; as after a real SIGKILL, the only
    recovery is to restart and resume from the latest snapshot."""


class TransientFlake(RuntimeError):
    """A retry-worthy failure (``transient = True``): the deterministic
    stand-in for a flaky interconnect or preempted device that the
    ExecutionGuard's retry/backoff path must survive."""

    transient = True


def kill_at_epoch(k: int):
    """An ``epoch_hook`` for ``match_epochs`` that crashes *after* epoch
    ``k`` completed and snapshotted: the crash-matrix kill point (state
    for epochs ``<= k`` is durable, the rest is lost)."""

    def hook(epoch: int, state):
        if epoch == k:
            raise SimulatedCrash(f"killed after epoch {k}")

    return hook


def kill_mid_snapshot(manager, after_files: int = 1):
    """Make ``manager`` (a CheckpointManager or SnapshotManager) crash
    inside the commit: the tmp dir is fully written but the durable
    rename never happens, simulating power loss mid-commit. The next
    manager over the same directory must see only the previous step.
    Returns the patched underlying CheckpointManager."""
    mgr = getattr(manager, "manager", manager)

    def _crash(tmp, final):
        raise SimulatedCrash(f"killed mid-snapshot before rename of {tmp}")

    mgr._commit = _crash
    return mgr


class FakeClock:
    """Deterministic monotonic clock + sleep recorder for guard tests.

    ``clock()`` returns the current fake time; ``sleep(s)`` records
    ``s`` into ``sleeps`` and advances the clock. ``advance`` (set it
    before a call, or from inside the guarded fn via :func:`slow`)
    adds extra seconds to the *next* clock read: how tests make one
    attempt blow a deadline without real waiting."""

    def __init__(self):
        self.now = 0.0
        self.sleeps: list[float] = []
        self.advance = 0.0

    def __call__(self) -> float:
        self.now += self.advance
        self.advance = 0.0
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += seconds


def slow(fn, clock: FakeClock, seconds: float):
    """Wrap ``fn`` so each call appears to take ``seconds`` on the fake
    clock (drives the deadline and straggler paths deterministically)."""

    def wrapped(*args, **kwargs):
        clock.advance = seconds
        return fn(*args, **kwargs)

    return wrapped


def flake(fn, times: int, exc_type=TransientFlake, state: dict | None = None):
    """Fail the first ``times`` calls with ``exc_type``, then delegate:
    the fail-N-times-then-succeed shape the retry budget is sized for.
    The wrapper exposes ``calls`` for assertions; wrappers given one
    ``state`` count their calls together."""
    state = {"calls": 0} if state is None else state

    def wrapped(*args, **kwargs):
        state["calls"] += 1
        if state["calls"] <= times:
            raise exc_type(
                f"injected flake {state['calls']}/{times} in "
                f"{getattr(fn, '__name__', fn)!r}"
            )
        return fn(*args, **kwargs)

    wrapped.calls = state
    return wrapped


@contextlib.contextmanager
def flaky(*targets: str, times: int = 1, exc_type=TransientFlake):
    """Like :func:`failing`, but fail-N-then-succeed: the named ops /
    matching internals raise ``exc_type`` on their first ``times``
    calls (counted per target) and then behave normally. Restores the
    originals on exit."""
    from repro_torch.core import matching as _matching
    from repro_torch.kernels.substream_match import ops as _ops

    unknown = [t for t in targets if t not in _TARGETS]
    if unknown:
        raise ValueError(f"unknown targets {unknown}; use {sorted(_TARGETS)}")

    saved = []
    try:
        for t in targets:
            module = _matching if t in ("scan_oracle", "waves_xla") else _ops
            state = {"calls": 0}
            for attr in (_TARGETS[t], *_ALSO.get(t, ())):
                saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, flake(getattr(module, attr), times, exc_type, state))
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)
