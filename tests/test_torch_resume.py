"""Port parity of the rest of resume: ``SnapshotManager`` and
``CheckpointManager`` (``repro_torch.checkpoint``), ``ExecutionGuard``
(``repro_torch.core.executor``), ``StragglerMonitor``
(``repro_torch.distributed``), and ``match_epochs`` with ``snapshots=``,
``guard=``, ``telemetry=``, ``validate=`` and ``on_plan_failure=``.

* crash matrix: kill after every epoch, for all six engines and both
  layouts, resume from the snapshot directory, bit-equal to the JAX
  package's one-shot ``mwm_scan``;
* the layout on disk is the reference's: a directory written by either
  package resumes in the other, both ways, bit-equal;
* the guard and the monitor under ``FakeClock`` give the reference's
  backoff schedule, ``retry_log``, events and counters.

Runs on the CPU; no tolerance.
"""
import functools
import glob
import json
import os
import pathlib

import jax
import numpy as np
import pytest

import repro.core as jcore
from repro import obs as jobs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import SnapshotManager as JSnapshotManager
from repro.core import executor as jexecutor
from repro.distributed import StragglerMonitor as JStragglerMonitor
from repro.kernels.substream_match import ops as jops
from repro.testing import faultline as jfaultline
from repro_torch import obs
from repro_torch.checkpoint import (
    CheckpointManager,
    SnapshotCorruptError,
    SnapshotManager,
    SnapshotMismatchError,
)
from repro_torch.convert import config_from_reference, stream_from_arrays
from repro_torch.core import (
    DeadlineExceededError,
    ExecutionGuard,
    MatchState,
    RetriesExhaustedError,
    check_matching,
    is_transient,
)
from repro_torch.distributed import StragglerMonitor
from repro_torch.kernels.substream_match.ops import EPOCH_ENGINES, epoch_bounds, match_epochs
from repro_torch.testing import faultline

N, M, L = 44, 98, 12
EPOCHS = 7


@functools.lru_cache(maxsize=None)
def _pair():
    """The reference resume suite's graph in both packages (duplicate
    edges, a self-loop, an invalid-masked tail, L % 8 != 0), and the
    reference's one-shot ``mwm_scan`` on it."""
    rng = np.random.default_rng(42)
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    w = rng.uniform(1.0, 60.0, M).astype(np.float32)
    src[10] = dst[10] = 7
    src[20], dst[20] = src[21], dst[21] = 3, 9
    valid = np.ones(M, bool)
    valid[[5, 50, 95]] = False
    js = jcore.EdgeStream(*(jax.numpy.asarray(x) for x in (src, dst, w, valid)))
    jcfg = jcore.SubstreamConfig(n=N, L=L)
    want = jcore.mwm_scan(js, jcfg)
    cfg = config_from_reference(N, L, 0.1, np.asarray(jax.jit(jcfg.thresholds)()))
    stream = stream_from_arrays(src, dst, w, valid, device="cpu")
    return js, jcfg, stream, cfg, (np.asarray(want.assigned), np.asarray(want.mb))


def _assert_oracle(out):
    want = _pair()[4]
    np.testing.assert_array_equal(np.asarray(out.assigned), want[0])
    np.testing.assert_array_equal(np.asarray(out.mb), want[1])


def _run(tmp_path, **kw):
    _, _, stream, cfg, _ = _pair()
    kw.setdefault("snapshots", SnapshotManager(tmp_path, async_save=False))
    return match_epochs(stream, cfg, device="cpu", **kw)


def _replayed(tel):
    return [e["epoch"] for e in tel.events if e["name"] == "epoch.index"]


# ------------------------------------------------------------- crash matrix


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("engine", EPOCH_ENGINES)
@pytest.mark.parametrize("kill", range(EPOCHS))
def test_kill_and_resume_bit_identical(tmp_path, engine, kill, packed):
    kw = dict(epochs=EPOCHS, engine=engine, packed=packed)
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epoch_hook=faultline.kill_at_epoch(kill), **kw)
    tel = obs.Telemetry()
    out = _run(tmp_path, telemetry=tel, **kw)
    assert out.is_packed == packed
    _assert_oracle(out)
    check_matching(out, _pair()[2], _pair()[3])
    assert _replayed(tel) == list(range(kill + 1, EPOCHS))


# --------------------------------------------- the two packages, one directory


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("engine", ["edges", "waves", "mega", "scan"])
@pytest.mark.parametrize("kill", [0, 3, 5])
def test_reference_snapshots_resume_in_the_port(tmp_path, engine, kill, packed):
    js, jcfg, _, _, _ = _pair()
    with pytest.raises(jfaultline.SimulatedCrash):
        jops.match_epochs(js, jcfg, epochs=EPOCHS, engine="scan", packed=packed,
                          snapshots=JSnapshotManager(tmp_path, async_save=False),
                          epoch_hook=jfaultline.kill_at_epoch(kill))
    tel = obs.Telemetry()
    out = _run(tmp_path, epochs=EPOCHS, engine=engine, packed=packed, telemetry=tel)
    _assert_oracle(out)
    assert _replayed(tel) == list(range(kill + 1, EPOCHS))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("engine", ["edges", "waves", "mega", "ref"])
@pytest.mark.parametrize("kill", [1, 4])
def test_port_snapshots_resume_in_the_reference(tmp_path, engine, kill, packed):
    js, jcfg, _, _, _ = _pair()
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=EPOCHS, engine=engine, packed=packed,
             epoch_hook=faultline.kill_at_epoch(kill))
    jtel = jobs.Telemetry()
    out = jops.match_epochs(js, jcfg, epochs=EPOCHS, engine="scan", packed=packed,
                            snapshots=JSnapshotManager(tmp_path, async_save=False),
                            telemetry=jtel)
    _assert_oracle(out)
    assert [e["epoch"] for e in jtel.events if e["name"] == "epoch.index"] == \
        list(range(kill + 1, EPOCHS))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_layout_on_disk_is_the_references(tmp_path, packed):
    """Both packages write the same files, npz keys, arrays and manifest
    (bar its time stamp) for the same run."""
    js, jcfg, _, _, _ = _pair()
    _run(tmp_path / "port", epochs=3, engine="edges", packed=packed)
    jops.match_epochs(js, jcfg, epochs=3, engine="scan", packed=packed,
                      snapshots=JSnapshotManager(tmp_path / "ref", async_save=False))

    def listing(root):
        return sorted(os.path.relpath(p, root) for p in glob.glob(f"{root}/**", recursive=True))

    assert listing(tmp_path / "port") == listing(tmp_path / "ref")
    for step in sorted(glob.glob(f"{tmp_path}/port/step_*")):
        other = step.replace("/port/", "/ref/")
        with np.load(f"{step}/match_state.npz") as a, np.load(f"{other}/match_state.npz") as b:
            assert sorted(a.files) == sorted(b.files) == ["assigned", "mb", "recorded_counts"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
        metas = [json.loads(pathlib.Path(f"{d}/manifest.json").read_text()) for d in (step, other)]
        for meta in metas:
            meta.pop("time")
        assert metas[0] == metas[1]


# ------------------------------------------------------------ snapshot protocol


def test_resume_replays_nothing_when_complete(tmp_path):
    _assert_oracle(_run(tmp_path, epochs=3, engine="scan"))
    tel = obs.Telemetry()
    _assert_oracle(_run(tmp_path, epochs=3, engine="scan", telemetry=tel))
    assert _replayed(tel) == []


def test_resume_works_across_engines(tmp_path):
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=EPOCHS, engine="mega", epoch_hook=faultline.kill_at_epoch(2))
    _assert_oracle(_run(tmp_path, epochs=EPOCHS, engine="waves_xla"))


def test_async_snapshots_land(tmp_path):
    snaps = SnapshotManager(tmp_path, keep=0, async_save=True)
    _assert_oracle(_run(tmp_path, epochs=4, engine="edges", snapshots=snaps))
    assert snaps.all_positions() == epoch_bounds(M, 4)[1:]


def test_keep_prunes_old_snapshots(tmp_path):
    snaps = SnapshotManager(tmp_path, keep=2, async_save=False)
    _run(tmp_path, epochs=5, engine="scan", snapshots=snaps)
    assert snaps.all_positions() == epoch_bounds(M, 5)[-2:]


def test_snapshot_telemetry_matches_reference(tmp_path):
    js, jcfg, _, _, _ = _pair()
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    _run(tmp_path / "p", epochs=3, engine="scan", telemetry=tel,
         snapshots=SnapshotManager(tmp_path / "p", async_save=False, telemetry=tel))
    jops.match_epochs(js, jcfg, epochs=3, engine="scan", telemetry=jtel,
                      snapshots=JSnapshotManager(tmp_path / "r", async_save=False, telemetry=jtel))
    assert tel.counters.asdict() == jtel.counters.asdict() == {"epoch.count": 3, "snapshot.count": 3}
    assert tel.events == jtel.events
    names = [e["name"] for e in tel.tracer.events]
    assert names == [e["name"] for e in jtel.tracer.events]
    assert names.count("snapshot.save") == 3 and names.count("snapshot.restore") == 1


def test_fingerprint_mismatch_rejected(tmp_path):
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=4, engine="scan", epoch_hook=faultline.kill_at_epoch(1))
    _, _, stream, cfg, _ = _pair()
    other = type(stream)(stream.src, stream.dst, stream.weight + 1.0, stream.valid)
    with pytest.raises(SnapshotMismatchError, match="fingerprints"):
        match_epochs(other, cfg, epochs=4, engine="scan", device="cpu",
                     snapshots=SnapshotManager(tmp_path, async_save=False))


def test_storage_layout_mismatch_rejected(tmp_path):
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=4, engine="scan", packed=True,
             epoch_hook=faultline.kill_at_epoch(1))
    with pytest.raises(SnapshotMismatchError):
        _run(tmp_path, epochs=4, engine="scan", packed=False)


def test_state_version_mismatch_rejected(tmp_path):
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=4, engine="scan", epoch_hook=faultline.kill_at_epoch(1))
    path = pathlib.Path(sorted(glob.glob(f"{tmp_path}/step_*"))[-1]) / "manifest.json"
    meta = json.loads(path.read_text())
    meta["state_version"] = 99
    path.write_text(json.dumps(meta))
    with pytest.raises(SnapshotMismatchError, match="state_version"):
        _run(tmp_path, epochs=4, engine="scan")


def test_corrupt_snapshot_rejected(tmp_path):
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=4, engine="scan", epoch_hook=faultline.kill_at_epoch(2))
    path = sorted(glob.glob(f"{tmp_path}/step_*"))[-1] + "/match_state.npz"
    with np.load(path) as data:
        arrays = {k: data[k].copy() for k in data.files}
    arrays["recorded_counts"] = arrays["recorded_counts"] + 1
    np.savez(path, **arrays)
    with pytest.raises(SnapshotCorruptError, match="recorded_counts"):
        _run(tmp_path, epochs=4, engine="scan")


def test_torn_commit_invisible(tmp_path):
    snaps = SnapshotManager(tmp_path, async_save=False)
    _run(tmp_path, epochs=2, engine="scan", snapshots=snaps)
    committed = snaps.all_positions()
    assert committed == epoch_bounds(M, 2)[1:]
    broken = SnapshotManager(tmp_path, async_save=False)
    faultline.kill_mid_snapshot(broken)
    _, _, stream, cfg, _ = _pair()
    with pytest.raises(faultline.SimulatedCrash):
        broken.save(MatchState.initial(stream, cfg, True))
    assert glob.glob(f"{tmp_path}/step_00000000.tmp")
    fresh = SnapshotManager(tmp_path, async_save=False)
    assert fresh.all_positions() == committed
    _assert_oracle(_run(tmp_path, epochs=2, engine="scan", snapshots=fresh))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("engine", ["edges", "waves", "mega"])
def test_lost_async_write_is_replayed(tmp_path, engine, packed):
    """A crash after epoch 2 while epoch 2's snapshot is still on the async
    writer (the power fails inside its commit): that write is lost, the
    directory holds epochs 0 and 1, and the resume replays epochs 2 and on,
    bit-equal to the one-shot run."""
    kw = dict(epochs=4, engine=engine, packed=packed)
    lost = SnapshotManager(tmp_path, keep=0)
    commit, commits = lost.manager._commit, []

    def power_fails_in_third_commit(tmp_dir, final):
        commits.append(final)
        if len(commits) == 3:
            raise faultline.SimulatedCrash(f"killed mid-snapshot before rename of {tmp_dir}")
        commit(tmp_dir, final)

    lost.manager._commit = power_fails_in_third_commit
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, snapshots=lost, epoch_hook=faultline.kill_at_epoch(2), **kw)
    with pytest.raises(faultline.SimulatedCrash, match="mid-snapshot"):
        lost.wait()
    assert SnapshotManager(tmp_path).all_positions() == epoch_bounds(M, 4)[1:3]
    tel = obs.Telemetry()
    out = _run(tmp_path, snapshots=SnapshotManager(tmp_path, telemetry=tel), telemetry=tel, **kw)
    _assert_oracle(out)
    assert out.is_packed == packed and _replayed(tel) == [2, 3]


def test_empty_directory_is_fresh_start(tmp_path):
    tel = obs.Telemetry()
    _assert_oracle(_run(tmp_path, epochs=2, engine="edges", telemetry=tel))
    assert _replayed(tel) == [0, 1]


def test_checkpoint_manager_trees_round_trip(tmp_path):
    """Nested dicts and sequences of arrays, keyed by path as the reference's
    flattening keys them; restore casts to the template's dtypes."""
    tree = {"b": {"y": np.arange(3, dtype=np.int64), "x": [np.ones(2, np.float32),
                                                          np.zeros((2, 2), np.uint8)]},
            "a": np.array([True, False])}
    mgr, jmgr = CheckpointManager(tmp_path / "p", async_save=True), \
        JCheckpointManager(str(tmp_path / "r"), async_save=False)
    mgr.save(7, {"t": tree}, metadata={"k": 1})
    jmgr.save(7, {"t": tree}, metadata={"k": 1})
    mgr.wait()
    with np.load(tmp_path / "p/step_00000007/t.npz") as a, \
            np.load(tmp_path / "r/step_00000007/t.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["a", "b/x/0", "b/x/1", "b/y"]
    step, out = mgr.restore({"t": tree})
    assert step == 7 and mgr.latest_step() == 7
    np.testing.assert_array_equal(out["t"]["b"]["y"], tree["b"]["y"])
    assert out["t"]["b"]["x"][1].dtype == np.uint8 and isinstance(out["t"]["b"]["x"], list)
    assert CheckpointManager(tmp_path / "empty").restore({"t": tree}) == (None, None)


# --------------------------------------------------- epochs with the other layers


def test_epoch_telemetry_matches_reference():
    js, jcfg, stream, cfg, _ = _pair()
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    match_epochs(stream, cfg, epochs=4, engine="scan", telemetry=tel, device="cpu")
    jops.match_epochs(js, jcfg, epochs=4, engine="scan", telemetry=jtel)
    assert tel.events == jtel.events and tel.counters.asdict() == jtel.counters.asdict()
    tel = obs.Telemetry()
    match_epochs(stream, cfg, epochs=4, engine="edges", telemetry=tel, device="cpu")
    assert [r.engine for r in tel.match_calls] == ["kernel_edges"] * 4
    assert not [e for e in tel.events if e["name"] == "substream_match.backend"]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("engine", ["edges", "mega", "scan"])
def test_epochs_validate_matches_reference(engine, packed):
    js, jcfg, stream, cfg, _ = _pair()
    jdirty, _ = jfaultline.poison_weights(js, (3, 40, 77), "nan")
    dirty, _ = faultline.poison_weights(stream, (3, 40, 77), "nan")
    want = jops.match_epochs(jdirty, jcfg, epochs=3, engine="scan", packed=packed,
                             validate="sanitize")
    got = match_epochs(dirty, cfg, epochs=3, engine=engine, packed=packed, device="cpu",
                       validate="sanitize")
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))
    with pytest.raises(Exception, match="nonfinite_weight"):
        match_epochs(dirty, cfg, epochs=3, engine=engine, device="cpu", validate="strict")


@pytest.mark.parametrize("engine, targets", [("mega", ("mega_device", "waves_device")),
                                             ("waves", ("wave_plan",)),
                                             ("edges", ("edges_device",))])
def test_epochs_with_fallback_ladder(tmp_path, engine, targets):
    snaps = SnapshotManager(tmp_path, keep=0, async_save=False)
    tel = obs.Telemetry()
    with faultline.failing(*targets):
        out = _run(tmp_path, epochs=3, engine=engine, on_plan_failure="fallback",
                   snapshots=snaps, telemetry=tel)
    _assert_oracle(out)
    assert snaps.all_positions() == epoch_bounds(M, 3)[1:]
    assert tel.counters.get("fallback.count") == 3 * (2 if engine == "mega" else 1) + \
        (3 if engine == "mega" else 0)
    with faultline.failing(*targets):
        with pytest.raises(faultline.InjectedFailure):
            match_epochs(_pair()[2], _pair()[3], epochs=3, engine=engine, device="cpu")


# ------------------------------------------------- the execution guard, the monitor


def _guards(**kw):
    kw.setdefault("retries", 3)
    clk, jclk = faultline.FakeClock(), jfaultline.FakeClock()
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    mon = kw.pop("monitor", None)
    g = ExecutionGuard(clock=clk, sleep=clk.sleep, telemetry=tel,
                       monitor=mon and StragglerMonitor(**mon), **kw)
    jg = jexecutor.ExecutionGuard(clock=jclk, sleep=jclk.sleep, telemetry=jtel,
                                  monitor=mon and JStragglerMonitor(**mon), **kw)
    return (g, clk, tel, faultline), (jg, jclk, jtel, jfaultline)


def _log(g):
    return [(label, type(err).__name__, str(err), delay) for label, err, delay in g.retry_log]


def _same(port, ref):
    (g, clk, tel, _), (jg, jclk, jtel, _) = port, ref
    assert clk.sleeps == jclk.sleeps and clk.now == jclk.now
    assert _log(g) == _log(jg)
    assert tel.counters.asdict() == jtel.counters.asdict()
    assert tel.events == jtel.events


SCENARIOS = {
    "clean": lambda fl, clk: (lambda: "ok"),
    "flake_3": lambda fl, clk: fl.flake(lambda: 42, times=3),
    "flake_timeout": lambda fl, clk: fl.flake(lambda: 1, times=2, exc_type=TimeoutError),
    "slow_once": None,
}


@pytest.mark.parametrize("scenario", ["clean", "flake_3", "flake_timeout", "slow_once"])
def test_guard_matches_reference(scenario):
    port, ref = _guards(deadline=1.0, backoff=0.05, backoff_factor=2.0)
    results = []
    for g, clk, _, fl in (port, ref):
        if scenario == "slow_once":
            calls = {"n": 0}

            def fn(clk=clk, calls=calls):
                calls["n"] += 1
                clk.advance = 5.0 if calls["n"] == 1 else 0.01
                return "done"
        else:
            fn = SCENARIOS[scenario](fl, clk)
        results.append(g.run(fn, label="epoch[3]"))
    assert results[0] == results[1]
    _same(port, ref)
    if scenario == "flake_3":
        assert port[1].sleeps == [0.05, 0.10, 0.20]
    if scenario == "slow_once":
        assert isinstance(port[0].retry_log[0][1], DeadlineExceededError)


@pytest.mark.parametrize("scenario", ["exhausted", "deadline_exhausted", "permanent", "crash"])
def test_guard_failures_match_reference(scenario):
    port, ref = _guards(retries=2, deadline=1.0)
    raised = []
    for g, clk, _, fl in (port, ref):
        if scenario == "exhausted":
            fn = fl.flake(lambda: 42, times=99)
        elif scenario == "deadline_exhausted":
            fn = fl.slow(lambda: "x", clk, 5.0)
        elif scenario == "permanent":
            def fn():
                raise ValueError("permanent")
        else:
            def fn(fl=fl):
                raise fl.SimulatedCrash("kill -9")
        try:
            g.run(fn)
        except BaseException as err:  # noqa: BLE001 (compared below)
            raised.append(err)
    names = [type(e).__name__ for e in raised]
    assert names[0] == names[1]
    if scenario in ("exhausted", "deadline_exhausted"):
        assert isinstance(raised[0], RetriesExhaustedError) and len(raised[0].attempts) == 3
        assert str(raised[0]) == str(raised[1])
    _same(port, ref)


def test_guard_feeds_straggler_monitor_as_reference():
    port, ref = _guards(monitor=dict(alpha=0.1, threshold=2.0, warmup_steps=2))
    for g, clk, _, fl in (port, ref):
        for seconds in (1.0, 1.0, 1.0, 1.0, 8.0, 1.0, 0.5, 9.0):
            g.run(fl.slow(lambda: None, clk, seconds), label="epoch")
    _same(port, ref)
    assert port[2].counters.get("guard.straggler") == 2
    assert [e.ratio for e in port[0].monitor.events] == [e.ratio for e in ref[0].monitor.events]


@pytest.mark.parametrize("steps", [[1.0, 10.0, 1.0, 1.0, 5.0], [1.0] * 4 + [5.0] + [100.0] * 6,
                                   [2.0, 1.0, 3.0, 0.5, 9.0, 9.0]])
def test_straggler_monitor_matches_reference(steps):
    kw = dict(alpha=0.1, threshold=1.5, warmup_steps=1, history=3)
    mon, jmon = StragglerMonitor(**kw), JStragglerMonitor(**kw)
    for t in steps:
        a, b = mon.observe(t), jmon.observe(t)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.step, a.step_time, a.ewma, a.ratio) == (b.step, b.step_time, b.ewma, b.ratio)
    assert mon.ewma == jmon.ewma and len(mon.events) == len(jmon.events)


def test_is_transient_matches_reference():
    class PinnedPermanent(TimeoutError):
        transient = False

    errs = [faultline.TransientFlake("x"), TimeoutError("x"), ConnectionError("x"),
            DeadlineExceededError(2.0, 1.0), ValueError("x"), RuntimeError("x"),
            PinnedPermanent("x")]
    assert [is_transient(e) for e in errs] == [jexecutor.is_transient(e) for e in errs] == \
        [True, True, True, True, False, False, False]
    with pytest.raises(ValueError):
        ExecutionGuard(retries=-1)


@pytest.mark.parametrize("engine, target", [("scan", "scan_oracle"), ("waves_xla", "waves_xla"),
                                            ("edges", "edges_device"), ("mega", "mega_device")])
def test_flaky_engine_retried_bit_exact(tmp_path, engine, target):
    """A transient flake in an epoch is retried by the guard; the run, with
    snapshots, equals the one-shot scan."""
    clk = faultline.FakeClock()
    tel = obs.Telemetry()
    g = ExecutionGuard(retries=3, clock=clk, sleep=clk.sleep, telemetry=tel)
    with faultline.flaky(target, times=1):
        out = _run(tmp_path, epochs=3, engine=engine, guard=g, telemetry=tel)
    _assert_oracle(out)
    assert tel.counters.get("guard.retry") == 1 and clk.sleeps == [0.05]
    assert [e["label"] for e in tel.events if e["name"] == "guard.retry"] == ["epoch[0]"]


def test_transient_flake_exhaustion_propagates():
    clk = faultline.FakeClock()
    g = ExecutionGuard(retries=1, clock=clk, sleep=clk.sleep)
    with faultline.flaky("scan_oracle", times=99):
        with pytest.raises(RetriesExhaustedError):
            match_epochs(_pair()[2], _pair()[3], epochs=2, engine="scan", guard=g, device="cpu")


def test_guard_never_absorbs_a_crash_inside_epochs(tmp_path):
    clk = faultline.FakeClock()
    g = ExecutionGuard(retries=3, clock=clk, sleep=clk.sleep)
    with pytest.raises(faultline.SimulatedCrash):
        _run(tmp_path, epochs=3, engine="scan", guard=g, epoch_hook=faultline.kill_at_epoch(1))
    assert clk.sleeps == []
    _assert_oracle(_run(tmp_path, epochs=3, engine="scan", guard=g))


def test_async_writer_outlives_a_failed_write(tmp_path):
    """A write that fails on the writer thread neither hangs ``wait()`` nor
    stops the saves queued behind it: they land, the failed step is not on
    disk, and ``wait()`` raises the failure once."""
    import threading

    mgr = CheckpointManager(tmp_path, keep=0, async_save=True)
    commit = mgr._commit
    gate = threading.Event()

    def commit_once_failing(tmp, final):
        gate.wait(timeout=10)  # hold the writer until every save is queued
        if final.endswith("step_00000002"):
            raise OSError("disk full")
        commit(tmp, final)

    mgr._commit = commit_once_failing
    for step in (1, 2, 3, 4):
        mgr.save(step, {"t": {"a": np.full(3, step)}})
    gate.set()
    errors = []
    waiter = threading.Thread(target=lambda: errors.append(_raised(mgr.wait)), daemon=True)
    waiter.start()
    waiter.join(timeout=30)
    assert not waiter.is_alive(), "wait() hung behind a failed write"
    assert [type(e).__name__ for e in errors] == ["OSError"]
    assert mgr.all_steps() == [1, 3, 4]
    mgr.wait()  # the failure was reported once
    _, out = mgr.restore({"t": {"a": np.zeros(3, np.int64)}})
    np.testing.assert_array_equal(out["t"]["a"], [4, 4, 4])


def _raised(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 (returned to the test)
        return err
    return None
