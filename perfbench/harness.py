"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the check against the plain reference, the metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* a configuration: the JSON file the entry names (``file``);
* a traffic mix: ``perfbench/traffic/<traffic>.json``;
* a graph generator: ``perfbench/gen/<generator>.py``, named by the
  configuration, with ``generate(config, scale, generator)``;
* a metric, end-to-end or per-layer: ``perfbench/metrics/<name>.py`` with
  ``read(record)``, which returns a number or None where it finds nothing.

The system under test is ``repro_torch.core.mwm_pipeline``: a job hands it
one edge stream in pinned host memory and gets the matched edge indices on
the host and their weight.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import traceback

import numpy as np
import torch

from perfbench import arith, check, trace
from perfbench.reference import matching as reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run: JAX, and the
#: JAX package with its benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_module(path: pathlib.Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_dyn.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` under ``root``, its files read."""

    def __init__(self, workload: str, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.entry = _named(spec["workloads"], workload, "workload")
        self.name = workload
        self.chips = int(self.entry["chips"])
        cfg_entry = _named(spec["configs"], self.entry["config"], "configuration")
        self.config = json.loads((self.root / cfg_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.root / "perfbench" / "traffic" / f"{self.entry['traffic']}.json").read_text()
        )
        e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in e2e}
        layer = [
            m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in reported else [])
        ]
        self.metrics = {"end_to_end": e2e, "per_layer": layer}
        self.scale = int(self.traffic["scale"])
        self.n = 1 << self.scale
        if self.traffic.get("loop") != "closed" or int(self.traffic.get("clients", 1)) != 1:
            raise ValueError("only a closed loop with one client is driven")
        self.pool = int(self.traffic["pool"])
        self.generator = load_module(
            self.root / "perfbench" / "gen" / f"{self.config['generator']}.py",
            self.config["generator"],
        )

    def graph_seed(self, seed: int, j: int) -> int:
        """Seed of pool graph ``j``: a graph can be drawn again alone."""
        entropy = [seed % (1 << 64), j]  # any whole seed, negative ones too
        return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)

    def draw(self, seed: int, j: int, device: str):
        """Pool graph ``j`` of ``seed`` on ``device``: (src, dst, weight)."""
        g = torch.Generator(device=device)
        g.manual_seed(self.graph_seed(seed, j))
        return self.generator.generate(self.config, self.scale, g)

    def checked_graphs(self, seed: int) -> list[int]:
        """The pool graphs whose jobs are compared, drawn from the seed."""
        k = min(self.pool, int(self.traffic["check_graphs"]))
        rng = np.random.default_rng([seed % (1 << 64), 0xC4EC])
        return sorted(int(j) for j in rng.choice(self.pool, size=k, replace=False))

    def thresholds(self) -> np.ndarray:
        return reference.thresholds(int(self.config["L"]), float(self.config["eps"]))


def host_stream(src, dst, weight, device: str):
    """The stream as a user holds it: in (pinned, beside a card) host memory."""
    from repro_torch.core import EdgeStream

    def host(t):
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=device == "cuda")
        out.copy_(t)
        return out

    valid = torch.ones(src.shape, dtype=torch.bool, pin_memory=device == "cuda")
    return EdgeStream(host(src), host(dst), host(weight), valid)


def job_fn(cell: Cell, device: str):
    """The timed call: one stream in, (indices, weight) on the host out."""
    from repro_torch import core

    cfg = core.SubstreamConfig(
        n=cell.n, L=int(cell.config["L"]), eps=float(cell.config["eps"]),
        thresholds=cell.thresholds(),
    )
    part1, K = cell.config["part1"], int(cell.config["K"])

    def call(stream):
        # looked up at every call: the traced run wraps it
        return core.mwm_pipeline(stream, cfg, part1=part1, K=K, device=device)

    return call


def reference_answer(cell: Cell, seed: int, j: int, device: str, precision="float32"):
    """(sorted indices, weight, Part 1 rounds, recorded edges) of the plain
    reference on pool graph ``j``, drawn again from the seed."""
    src, dst, w = cell.draw(seed, j, device)
    return reference.mwm(src, dst, w, cell.thresholds(), cell.n, int(cell.config["K"]),
                         precision=precision)


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name, whole, is
    one of :data:`FORBIDDEN`: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _peaks(root: pathlib.Path, kind: str):
    return json.loads((root / "perfbench" / "peaks.json").read_text()).get(kind)


def _card_settings() -> dict | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, power, clock = (x.strip() for x in out.split(","))
    return {"name": name, "power_limit": power, "sm_clock_max": clock}


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations with the most time, and the longest idle gaps
    named by the benchmark span open on the host, within the window."""
    win = [s for s in tr["spans"] if s[0] == "window"]
    if not win or not tr["device"]:
        return {}
    _, lo, hi = win[0]
    per_op: dict[str, float] = {}
    for name, a, b in tr["device"]:
        d = min(b, hi) - max(a, lo)
        if d > 0:
            per_op[name] = per_op.get(name, 0.0) + d
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    host = [s for s in tr["spans"] if s[0] != "window"]
    holes = arith.gaps([(a, b) for _, a, b in tr["device"]], lo, hi)
    named = [
        [arith.dominant(host, a, b, frames=("job",)) or "harness", b - a]
        for a, b in sorted(holes, key=lambda g: g[0] - g[1])[:top]
    ]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: str,
        t_proc0: float) -> dict:
    """One run. Returns the result object (the last line a run prints)."""
    from repro_torch.kernels import build

    log = lambda *a: print("perfbench:", *a, file=sys.stderr)  # noqa: E731
    on_card = device == "cuda"
    # --- set-up: the pool, drawn on the device, held in host memory
    pool, edges = [], []
    for j in range(cell.pool):
        src, dst, w = cell.draw(seed, j, device)
        pool.append(host_stream(src, dst, w, device))
        edges.append(int(src.shape[0]))
        del src, dst, w
    call = job_fn(cell, device)
    launched = sum(build.launches.values())
    if on_card:
        torch.cuda.empty_cache()  # what drawing the pool held
    # one job on the largest graph: the allocator then keeps blocks that
    # every smaller job of the window fits into
    call(pool[max(range(cell.pool), key=edges.__getitem__)])
    if on_card and sum(build.launches.values()) == launched:
        log("warning: the warm-up launched no counted kernel")
    checked = cell.checked_graphs(seed)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    # --- the window: a closed loop, one client, no think time
    def traced_only(cm):
        return cm if traced else contextlib.nullcontext()

    jobs, answers, failed = [], {}, 0
    with traced_only(trace.entry_spans(device)), \
            traced_only(trace.profiled(device)) as tr:
        t_start = time.perf_counter()
        setup_s = t_start - t_proc0
        with traced_only(trace.span("window")):
            while True:
                j = len(jobs) % cell.pool
                t0 = time.perf_counter()
                try:
                    with traced_only(trace.span("job")):
                        idx, w = call(pool[j])
                except Exception:  # a job that fails ends the window, counted
                    traceback.print_exc()
                    failed += 1
                    break
                t1 = time.perf_counter()
                jobs.append({"graph": j, "t0": t0 - t_start, "t1": t1 - t_start,
                             "edges": edges[j]})
                if j in checked:
                    answers.setdefault(j, []).append((np.asarray(idx), float(w)))
                if t1 - t_start >= seconds:
                    break
        t_end = time.perf_counter()
    gc.unfreeze()
    window_s = (jobs[-1]["t1"] if jobs else t_end - t_start)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # --- the check, once the window has closed and the pool is freed
    del pool, call
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = {}
    for j in checked:
        idx, w, rounds, recorded = reference_answer(cell, seed, j, device)
        refs[j] = (idx, w)
        log(f"reference graph {j}: {len(idx)} matched of {recorded} recorded, "
            f"{rounds} rounds")
    log(f"reference {time.perf_counter() - t_ref:.1f} s")
    if jobs:
        lat = [(j["t1"] - j["t0"]) * 1e3 for j in jobs]
        log(f"{len(jobs)} jobs in {window_s:.3f} s; latency ms p50 "
            f"{arith.percentile(lat, 50):.2f} p95 {arith.percentile(lat, 95):.2f} "
            f"max {max(lat):.2f}")
        if len(lat) > cell.pool:  # the window's first pass over the pool, against the rest
            log(f"latency ms p50: first pass {arith.percentile(lat[:cell.pool], 50):.2f}, "
                f"later {arith.percentile(lat[cell.pool:], 50):.2f}")
    numbers = check.compare(answers, refs, cell.config["limits"])
    ok = check.correct(numbers) and failed == 0 and bool(jobs)
    # --- the metrics
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    record = {
        "jobs": jobs, "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak,
        "n": cell.n, "L": int(cell.config["L"]), "device_kind": kind,
        "peaks": _peaks(cell.root, kind), "trace": tr,
    }
    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics[group]:
        reader = load_module(cell.root / "perfbench" / "metrics" / f"{m['name']}.py", m["name"])
        value = reader.read(record)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": len(jobs) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        win = [s for s in tr["spans"] if s[0] == "window"]
        if win:
            _, lo, hi = win[0]
            dev["window_s"] = hi - lo
            dev["busy_s"] = arith.covered([(a, b) for _, a, b in tr["device"]], lo, hi)
        result["breakdown"] = breakdown(tr)
        result["card"] = _card_settings() if on_card else None
        result["kernel_launches"] = dict(build.launches)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in numbers.items()}
    for line in check.lines(numbers):
        log(line)
    return result


def finite(obj):
    """``obj`` with every non-finite float replaced by None (JSON holds no NaN)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
