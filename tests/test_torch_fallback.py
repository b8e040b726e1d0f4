"""The port's fallback ladder (``substream_match(on_plan_failure=
"fallback")``), driven by ``repro_torch.testing.faultline``: every injected
rung, in both layouts, lands on an engine whose result is bit-equal to the
JAX package's ``mwm_scan`` on the same input, with a ``fallback`` event,
span and counter per failed rung; the clean path records none; a ladder
with nothing left ends in ``FallbackExhaustedError`` naming every attempt;
validation errors are not absorbed; stale schedules are rejected as the
reference rejects them and then survived. Runs on the CPU (the kernels'
plain versions); no tolerance."""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.graph.waves import validate_schedule as jvalidate_schedule
from repro.graph.waves import wave_schedule as jwave_schedule
from repro.kernels.substream_match import ops as jops
from repro.testing import faultline as jfaultline
from repro_torch import obs
from repro_torch.convert import config_from_reference, schedule_from_reference, stream_from_arrays
from repro_torch.core import StreamValidationError, check_matching
from repro_torch.graph.waves import block_aligned_layout, validate_schedule, wave_schedule
from repro_torch.kernels.substream_match import kernel, ops
from repro_torch.kernels.substream_match.ops import (
    FallbackExhaustedError,
    PlanRefusedError,
    _fallback_attempts,
    device_plan,
    mega_plan,
    substream_match,
    wave_plan,
)
from repro_torch.testing import faultline


def _arrays(js):
    return tuple(np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid))


@functools.lru_cache(maxsize=None)
def _pair(seed=1, n=32, m=120, L=12, pad=0):
    """The same stream in both packages, the reference's ``mwm_scan`` on it,
    and the port's config with the reference's thresholds."""
    rng = np.random.default_rng(seed)
    js = jcore.EdgeStream.from_numpy(
        rng.integers(0, n, m), rng.integers(0, n, m), rng.uniform(0.5, 4.0, m), n_pad=m + pad,
    )
    jcfg = jcore.SubstreamConfig(n=n, L=L)
    want = jcore.mwm_scan(js, jcfg)
    cfg = config_from_reference(n, L, 0.1, np.asarray(jax.jit(jcfg.thresholds)()))
    return (js, jcfg, stream_from_arrays(*_arrays(js), device="cpu"), cfg,
            (np.asarray(want.assigned), np.asarray(want.mb)))


def _assert_reference(got, want):
    np.testing.assert_array_equal(got.assigned.numpy(), want[0])
    np.testing.assert_array_equal(got.mb.numpy(), want[1])


PLAN_FAULTS = {
    "mega_plan": (("mega_plan",), "mega"),
    "mega_launch": (("mega_device",), "mega"),
    "mega_then_waves": (("mega_plan", "mega_device", "wave_plan"), "mega"),
    "all_kernels_mega": (("mega_plan", "mega_device", "wave_plan", "waves_device"), "mega"),
    "down_to_scan": (("mega_plan", "mega_device", "wave_plan", "waves_device", "waves_xla"),
                     "mega"),
    "device_plan_mega": (("vmem_plan",), "mega"),
    "waves_plan": (("wave_plan",), "waves"),
    "waves_launch": (("waves_device",), "waves"),
    "waves_down_to_scan": (("waves_device", "waves_xla"), "waves"),
    "edges_launch": (("edges_device",), "edges"),
    "edges_plan": (("vmem_plan",), "edges"),
    "edges_down_to_scan": (("edges_device", "waves_xla"), "edges"),
}

#: the rung that delivers under each fault: its engine record's name
DELIVERS = {
    "mega_plan": "kernel_waves", "mega_launch": "kernel_waves",
    "mega_then_waves": "waves_xla", "all_kernels_mega": "waves_xla",
    "down_to_scan": None, "device_plan_mega": "waves_xla", "waves_plan": "waves_xla",
    "waves_launch": "waves_xla", "waves_down_to_scan": None, "edges_launch": "waves_xla",
    "edges_plan": "waves_xla", "edges_down_to_scan": None,
}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", sorted(PLAN_FAULTS))
def test_ladder_lands_on_a_correct_engine(name, packed):
    targets, schedule = PLAN_FAULTS[name]
    _, _, stream, cfg, want = _pair()
    tel = obs.Telemetry()
    with faultline.failing(*targets):
        got = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                              on_plan_failure="fallback", telemetry=tel)
    _assert_reference(got, want)
    assert got.is_packed == packed
    events = [e for e in tel.events if e["name"] == "fallback"]
    assert events and tel.counters.get("fallback.count") == len(events)
    assert all("injected failure" in e["reason"] for e in events)
    labels = [label for _, _, label in _fallback_attempts(schedule, None)]
    assert [e["from_engine"] for e in events] == labels[: len(events)]
    assert [e["to_engine"] for e in events] == labels[1: len(events) + 1]
    spans = [e for e in tel.tracer.events if e["name"] == "fallback" and e["ph"] == "X"]
    assert [s["args"]["attempt"] for s in spans] == list(range(1, len(events) + 1))
    delivered = DELIVERS[name]
    if delivered is None:  # the scan keeps no record
        assert labels[len(events)] == "scan"
    else:
        assert tel.match_calls[-1].engine == delivered
        assert tel.match_calls[-1].counters["fallback.count"] == len(events)
    check_matching(got, stream, cfg)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_clean_path_records_zero_fallbacks(schedule, packed):
    _, _, stream, cfg, want = _pair(seed=2)
    tel = obs.Telemetry()
    got = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                          on_plan_failure="fallback", telemetry=tel)
    _assert_reference(got, want)
    assert tel.counters.get("fallback.count") == 0
    assert not [e for e in tel.events if e["name"] == "fallback"]
    rec, = tel.match_calls
    assert rec.engine == f"kernel_{schedule}" and rec.counters["fallback.count"] == 0


@pytest.mark.parametrize("schedule, target", [("mega", "mega_plan"), ("waves", "wave_plan"),
                                              ("edges", "edges_device")])
def test_raise_mode_propagates_injected_failures(schedule, target):
    _, _, stream, cfg, _ = _pair()
    with faultline.failing(target):
        with pytest.raises(faultline.InjectedFailure, match=target):
            substream_match(stream, cfg, schedule=schedule, device="cpu")
    with pytest.raises(ValueError, match="on_plan_failure"):
        substream_match(stream, cfg, schedule=schedule, device="cpu", on_plan_failure="retry")


ALL = ("mega_plan", "mega_device", "wave_plan", "waves_device", "edges_device",
       "waves_xla", "scan_oracle")


@pytest.mark.parametrize("schedule, labels", [
    ("mega", ["mega", "mega[seg_block=1]", "waves", "waves_xla", "scan"]),
    ("waves", ["waves", "waves_xla", "scan"]),
    ("edges", ["edges", "waves_xla", "scan"]),
])
def test_ladder_exhaustion_names_every_attempt(schedule, labels):
    _, _, stream, cfg, _ = _pair()
    tel = obs.Telemetry()
    with faultline.failing(*ALL):
        with pytest.raises(FallbackExhaustedError) as exc:
            substream_match(stream, cfg, schedule=schedule, device="cpu",
                            on_plan_failure="fallback", telemetry=tel)
    assert [label for label, _ in exc.value.attempts] == labels
    assert all("injected failure" in str(err) for _, err in exc.value.attempts)
    assert tel.counters.get("fallback.count") == len(labels)
    assert [e["to_engine"] for e in tel.events if e["name"] == "fallback"][-1] is None


def test_ladder_is_the_reference_ladder_without_block_s():
    """The JAX package's rungs, less its ``waves[block_s=1]`` (the port's
    waves kernel has no ``block_s``)."""
    for schedule in ("edges", "waves", "mega"):
        for seg_block in (None, 1, 4):
            want = [(e, o, label) for e, o, label in
                    jops._fallback_attempts(schedule, seg_block, None)
                    if not label.startswith("waves[block_s")]
            got = _fallback_attempts(schedule, seg_block)
            strip = [(e, {k: v for k, v in o.items() if k != "block_s"}, label)
                     for e, o, label in want]
            assert got == strip, (schedule, seg_block)


def test_unported_engine_names_and_schedule_rejected():
    _, _, stream, cfg, _ = _pair()
    with pytest.raises(ValueError, match="schedule"):
        substream_match(stream, cfg, schedule="pallas", device="cpu", on_plan_failure="fallback")


def test_ladder_does_not_absorb_validation_errors():
    _, _, stream, cfg, _ = _pair()
    dirty, _ = faultline.poison_ids(stream, cfg.n, (0,), "past_n")
    with pytest.raises(StreamValidationError):
        substream_match(dirty, cfg, schedule="mega", device="cpu",
                        on_plan_failure="fallback", validate="strict")


@pytest.mark.parametrize("corruptor", ["truncate", "permute"])
def test_stale_schedule_is_rejected_then_survived(corruptor):
    js, _, stream, cfg, want = _pair(seed=3)
    src, dst, _, valid = _arrays(js)
    jsch = jwave_schedule(src, dst, valid=valid)
    jbad = getattr(jfaultline, f"{corruptor}_schedule")(jsch)
    sch = schedule_from_reference(jsch.wave, jsch.order, jsch.offsets, jsch.slots,
                                  jsch.seg_offsets)
    bad = getattr(faultline, f"{corruptor}_schedule")(sch)
    for name in ("wave", "order", "offsets", "slots", "seg_offsets"):
        np.testing.assert_array_equal(getattr(bad, name), getattr(jbad, name))
    with pytest.raises(ValueError) as jexc:
        jvalidate_schedule(jbad, src, dst, valid)
    with pytest.raises(ValueError) as exc:
        validate_schedule(bad, src, dst, valid)
    assert str(exc.value) == str(jexc.value)
    with pytest.raises(ValueError):
        substream_match(stream, cfg, schedule="waves", waves=bad, device="cpu")
    tel = obs.Telemetry()
    got = substream_match(stream, cfg, schedule="waves", waves=bad, device="cpu",
                          on_plan_failure="fallback", telemetry=tel)
    _assert_reference(got, want)
    assert tel.counters.get("fallback.count") == 2  # waves, waves_xla; scan ignores schedules


def test_duplicate_order_entry_is_rejected():
    js, _, _, _, _ = _pair(seed=5)
    src, dst, _, valid = _arrays(js)
    jsch = jwave_schedule(src, dst, valid=valid)
    sch = schedule_from_reference(jsch.wave, jsch.order, jsch.offsets, jsch.slots,
                                  jsch.seg_offsets)
    bad = faultline.duplicate_order_entry(sch)
    np.testing.assert_array_equal(bad.slots, jfaultline.duplicate_order_entry(jsch).slots)
    with pytest.raises(ValueError, match="permutation"):
        validate_schedule(bad, src, dst, valid)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_ladder_at_L2049(schedule, packed):
    """L = 2049, one past the widest row the card's kernels take: on the CPU
    the plain versions take it, and every route gives the reference's bits
    (on the card the kernel rungs refuse it and the plain rungs deliver,
    ``tests/test_torch_gpu.py``)."""
    _, _, stream, cfg, want = _pair(seed=6, n=40, m=90, L=2049)
    tel = obs.Telemetry()
    got = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                          on_plan_failure="fallback", telemetry=tel)
    _assert_reference(got, want)
    assert tel.counters.get("fallback.count") == 0


def test_fallback_result_keeps_the_requested_storage():
    _, _, stream, cfg, want = _pair(seed=4)
    for packed in (True, False):
        with faultline.failing("mega_plan", "mega_device", "wave_plan", "waves_device"):
            got = substream_match(stream, cfg, schedule="mega", packed=packed, device="cpu",
                                  on_plan_failure="fallback")
        assert got.is_packed == packed
        _assert_reference(got, want)


@pytest.mark.parametrize("target", ["mega_device", "waves_device", "edges_device"])
def test_carried_bits_survive_the_ladder(target):
    """A run from carried bits (``mb0``) degrades to the plain rungs with the
    bits carried along: the second half of the stream seeded with the first
    half's bits equals the reference's one-shot scan."""
    js, jcfg, stream, cfg, want = _pair(seed=7, m=140)
    h = stream.num_edges // 2
    schedule = target.split("_")[0]
    head, tail = (jcore.EdgeStream(*(x[a:b] for x in (js.src, js.dst, js.weight, js.valid)))
                  for a, b in ((0, h), (h, stream.num_edges)))
    for packed in (True, False):
        first = substream_match(stream_from_arrays(*_arrays(head), device="cpu"), cfg,
                                packed=packed, device="cpu")
        mb0 = first.mb_packed if packed else first.mb
        with faultline.failing(target):
            second = substream_match(stream_from_arrays(*_arrays(tail), device="cpu"), cfg,
                                     mb0=mb0, schedule=schedule, packed=packed, device="cpu",
                                     on_plan_failure="fallback")
        np.testing.assert_array_equal(
            torch.cat([first.assigned, second.assigned]).numpy(), want[0])
        np.testing.assert_array_equal(second.mb.numpy(), want[1])


# --------------------------------------------------------------------------
# The ladder on the card: kernel rungs only, and only a plan refusal (raised
# before any launch) moves it down. The policy is driven here on the CPU by
# giving the ladder the card's rungs and absorbed type.


@pytest.mark.parametrize("seg_block", [None, 1, 4])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_card_ladder_keeps_only_kernel_rungs(schedule, seg_block):
    full = _fallback_attempts(schedule, seg_block)
    card = _fallback_attempts(schedule, seg_block, on_card=True)
    assert card == [a for a in full if a[0] in ("edges", "waves", "mega")]
    assert full[len(card):] == [("waves_xla", {}, "waves_xla"), ("scan", {}, "scan")]
    assert ops._ladder(schedule, seg_block, torch.device("cuda")) == (card, PlanRefusedError)
    assert ops._ladder(schedule, seg_block, torch.device("cpu")) == (full, Exception)


@pytest.fixture
def card_policy(monkeypatch):
    ladder = ops._ladder
    monkeypatch.setattr(ops, "_ladder", lambda s, b, d: ladder(s, b, torch.device("cuda")))


CARD_FAULTS = {  # targets, schedule -> the rungs that fail, the kernel that delivers
    "mega_refused": (("mega_device",), "mega", ["mega", "mega[seg_block=1]"], "kernel_waves"),
    "mega_plan_refused": (("mega_plan",), "mega", ["mega", "mega[seg_block=1]"],
                          "kernel_waves"),
    "mega_exhausted": (("mega_device", "waves_device"), "mega",
                       ["mega", "mega[seg_block=1]", "waves"], None),
    "waves_exhausted": (("wave_plan",), "waves", ["waves"], None),
    "edges_exhausted": (("edges_device",), "edges", ["edges"], None),
}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", sorted(CARD_FAULTS))
def test_card_ladder_steps_down_only_on_plan_refusals(card_policy, name, packed):
    targets, schedule, failed, delivered = CARD_FAULTS[name]
    _, _, stream, cfg, want = _pair()
    tel = obs.Telemetry()
    with faultline.failing(*targets, exc_type=PlanRefusedError):
        if delivered is None:
            with pytest.raises(FallbackExhaustedError) as exc:
                substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                                on_plan_failure="fallback", telemetry=tel)
            assert [label for label, _ in exc.value.attempts] == failed
        else:
            got = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                                  on_plan_failure="fallback", telemetry=tel)
            _assert_reference(got, want)
            assert tel.match_calls[-1].engine == delivered
    events = [e for e in tel.events if e["name"] == "fallback"]
    assert [e["from_engine"] for e in events] == failed
    assert all(e["reason"].startswith("PlanRefusedError") for e in events)
    assert tel.counters.get("fallback.count") == len(failed)
    assert not [r for r in tel.match_calls if r.engine in ("waves_xla", "scan")]


@pytest.mark.parametrize("schedule, target", [("mega", "mega_device"), ("waves", "waves_device"),
                                              ("edges", "edges_device"), ("mega", "wave_plan")])
def test_card_ladder_lets_build_and_launch_errors_through(card_policy, schedule, target):
    """A failure that is no plan refusal (a build or launch error, a bad
    operand) propagates at once on the card, with no fallback event: no
    later rung runs on a card whose kernel failed."""
    _, _, stream, cfg, want = _pair()
    tel = obs.Telemetry()
    with faultline.failing(target):
        if target == "wave_plan":  # mega itself delivers: the waves rung is never reached
            _assert_reference(substream_match(stream, cfg, schedule=schedule, device="cpu",
                                              on_plan_failure="fallback", telemetry=tel), want)
        else:
            with pytest.raises(faultline.InjectedFailure, match=target):
                substream_match(stream, cfg, schedule=schedule, device="cpu",
                                on_plan_failure="fallback", telemetry=tel)
    assert tel.counters.get("fallback.count") == 0
    assert not [e for e in tel.events if e["name"] == "fallback"]


def test_plan_refusals_are_typed():
    """The free-memory checks of the plans and the width checks of the
    kernels refuse with ``PlanRefusedError`` (a ``ValueError``); a misaligned
    row stays a plain ``ValueError``, which the card's ladder does not absorb."""
    js, _, _, _, _ = _pair()
    src, dst, _, valid = _arrays(js)
    sch = wave_schedule(src, dst, valid=valid)
    layout = block_aligned_layout(sch, 2)
    for packed in (True, False):
        with pytest.raises(PlanRefusedError, match="free on the card"):
            device_plan(1 << 20, 64, free_bytes=1 << 10, packed=packed)
        with pytest.raises(PlanRefusedError, match="free on the card"):
            wave_plan(32, 12, sch, free_bytes=1 << 10, packed=packed)
        with pytest.raises(PlanRefusedError, match="free on the card"):
            mega_plan(32, 12, layout, free_bytes=1 << 10, packed=packed)
    with pytest.raises(PlanRefusedError, match="row width 264 words"):
        kernel._check_width(264, packed=True)
    with pytest.raises(PlanRefusedError, match="row width 2064 bytes"):
        kernel._check_width(2064, packed=False)
    for width, packed in ((12, True), (24, False)):
        with pytest.raises(ValueError) as exc:
            kernel._check_width(width, packed=packed)
        assert type(exc.value) is ValueError
    kernel._check_width(256, packed=True)
    kernel._check_width(2048, packed=False)
    assert issubclass(PlanRefusedError, ValueError)
