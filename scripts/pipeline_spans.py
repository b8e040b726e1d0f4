#!/usr/bin/env python3
"""Name a benchmark cell's device idle time by the program's own spans.

    python3 scripts/pipeline_spans.py --workload kron48.s16-jobs --seed 7 --seconds 20 \
        [--out build/spans.json] [--device cuda]

Runs the cell's traced run once through ``perfbench``'s harness (the same
set-up, window, check and metrics as ``perfbench/run.py --trace 1``), keeps
the profiler's Chrome trace, and prints one JSON object (also written to
``--out``):

* ``metrics``, ``correct`` and ``jobs`` of the run;
* ``idle_gaps``: the ten longest stretches of the window with no device
  operation, each with the innermost ``repro_torch/<name>`` range over it
  (the shortest that covers at least half the gap, else the one that
  covers most) and the stack of ranges open at its middle;
* ``first_pass``: per program span, the median of its time per job in the
  window's first pass over the pool and in the rest (from the program's
  session, ``repro_torch.obs.profiler_session()``);
* ``stream_to``: per source device of the ``stream.to`` spans, their
  number, median length and the device copies that ran inside them;
* ``counters``: the program session's counters over the window (the
  merge's route: ``merge.device.calls`` or ``merge.host.calls``, one a job);
* ``blocks``: for Part 1's ``kernel_edges.execute`` and the merge's
  ``merge.kernel``, their number and each distinct ``bit_block_bytes`` and
  ``fits_l2`` they carried.

On the CPU (``--device cpu``) it runs the cell at its size too: keep to
small cells there.
"""
import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PREFIX = "repro_torch/"


def _innermost(ranges, a, b):
    over = [(min(e, b) - max(s, a), e - s, name) for name, s, e in ranges
            if min(e, b) > max(s, a)]
    if not over:
        return None
    half = [o for o in over if o[0] >= (b - a) / 2]
    if half:
        return min(half, key=lambda o: o[1])[2]
    return max(over, key=lambda o: (o[0], -o[1]))[2]


def _stack(ranges, t):
    return [name for name, s, e in sorted(ranges, key=lambda r: (r[1], r[1] - r[2]))
            if s <= t <= e]


def _per_job(events, pool):
    """{span name: [ms in job 0, job 1, ...]} by containment in ``pipeline``."""
    pipes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "pipeline")
    out = {}
    for e in events:
        if e["name"] == "pipeline":
            continue
        for k, (a, b) in enumerate(pipes):
            if a <= e["ts"] and e["ts"] + e["dur"] <= b:
                out.setdefault(e["name"], [0.0] * len(pipes))[k] += e["dur"] * 1e-3
                break
    out["pipeline"] = [(b - a) * 1e-3 for a, b in pipes]
    return {
        name: {"first_pass_ms": statistics.median(v[:pool]) if v[:pool] else None,
               "later_ms": statistics.median(v[pool:]) if v[pool:] else None}
        for name, v in sorted(out.items())
    }


def _blocks(events):
    """{span: {"spans": count, "blocks": [[bit_block_bytes, fits_l2], ...]}}
    of the spans that carry the bit block's size."""
    out = {}
    for e in events:
        args = e.get("args") or {}
        if "bit_block_bytes" in args:
            row = out.setdefault(e["name"], {"spans": 0, "blocks": []})
            row["spans"] += 1
            block = [args["bit_block_bytes"], args.get("fits_l2")]
            if block not in row["blocks"]:
                row["blocks"].append(block)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(ROOT), help="checkout whose BENCHMARK.json is read")
    args = ap.parse_args()

    from perfbench import arith, harness, trace
    from repro_torch import obs

    kept = {}
    parse = trace.parse

    def keep(chrome):
        kept["chrome"] = chrome
        return parse(chrome)

    trace.parse = keep
    cell = harness.Cell(args.workload, root=pathlib.Path(args.root))
    res = harness.run(cell, args.seed, args.seconds, True, args.device, time.perf_counter())
    xs = [e for e in kept["chrome"]["traceEvents"] if e.get("ph") == "X" and "dur" in e]

    def iv(e):
        return float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6

    ranges = [(e["name"][len(PREFIX):], *iv(e)) for e in xs
              if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
    device = [(e, *iv(e)) for e in xs if e.get("cat") in trace.DEVICE_CATS]
    win = [iv(e) for e in xs if e.get("name") == trace.PREFIX + "window"]
    gaps = []
    if win and device:
        lo, hi = win[0]
        holes = arith.gaps([(a, b) for _, a, b in device], lo, hi)
        for a, b in sorted(holes, key=lambda g: g[0] - g[1])[:10]:
            gaps.append({"ms": (b - a) * 1e3, "innermost": _innermost(ranges, a, b),
                         "stack": _stack(ranges, (a + b) / 2)})

    events = [e for e in obs.profiler_session().tracer.events if e.get("ph") == "X"]
    to_spans = sorted((e for e in events if e["name"] == "stream.to"), key=lambda e: e["ts"])
    to_ranges = sorted((r for r in ranges if r[0] == "stream.to"), key=lambda r: r[1])
    copies = {}
    for span, (_, a, b) in zip(to_spans, to_ranges):
        src = span["args"]["source"]
        row = copies.setdefault(src, {"spans": 0, "ms": [], "copies": 0, "copy_ms": 0.0,
                                      "copy_names": []})
        row["spans"] += 1
        row["ms"].append(span["dur"] * 1e-3)
        for e, s, t in device:
            if e.get("cat") == "gpu_memcpy" and a <= s and t <= b:
                row["copies"] += 1
                row["copy_ms"] += (t - s) * 1e3
                if e["name"] not in row["copy_names"]:
                    row["copy_names"].append(e["name"])
    for row in copies.values():
        row["median_ms"] = statistics.median(row.pop("ms"))
    out = {
        "workload": args.workload, "seed": args.seed, "correct": res["correct"],
        "jobs": res["attempted"], "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "idle_gaps": gaps, "first_pass": _per_job(events, cell.pool), "stream_to": copies,
        "paired": len(to_spans) == len(to_ranges), "card": res.get("card"),
        "counters": obs.profiler_session().counters.asdict(),
        "blocks": _blocks(events),
    }
    text = json.dumps(harness.finite(out))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
