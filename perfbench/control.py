"""Readings that set the limits of ``correct``, at a cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 11 12 13 [--program]

For each seed and each pool graph a run of that seed checks, prints one
JSON line with the numbers of :mod:`perfbench.check` for

* ``control``: the plain reference in bfloat16 (weights and thresholds one
  precision below the configuration's float32) put in the program's place,
  which has to come out not correct;
* ``program`` (with ``--program``): one job of the timed entry on that
  graph, from pinned host memory as in a run.

Benchmark runs never run this; its readings go into ``PERF.md``.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str, program: bool, call=None):
    """One dict per checked graph of ``seed``."""
    from perfbench import check, harness

    limits = cell.config["limits"]
    out = []
    for j in cell.checked_graphs(seed):
        row = {"workload": cell.name, "seed": seed, "graph": j}
        if program:
            src, dst, w = cell.draw(seed, j, device)
            row["edges"] = int(src.shape[0])
            stream = harness.host_stream(src, dst, w, device)
            del src, dst, w
            t0 = time.perf_counter()
            got = call(stream)
            row["program_s"] = time.perf_counter() - t0
            del stream
        t0 = time.perf_counter()
        idx, wt, rounds, recorded = harness.reference_answer(cell, seed, j, device)
        row.update(reference_s=time.perf_counter() - t0, rounds=rounds, recorded=recorded,
                   matched=len(idx))
        ref = {j: (idx, wt)}
        ctl = harness.reference_answer(cell, seed, j, device, precision="bfloat16")
        row["control"] = check.compare({j: [ctl[:2]]}, ref, limits)
        if program:
            row["program"] = check.compare({j: [got]}, ref, limits)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness

    cell = harness.Cell(args.workload)
    call = harness.job_fn(cell, args.device) if args.program else None
    if args.program:  # load the kernel library outside the readings
        src, dst, w = cell.draw(args.seeds[0], 0, args.device)
        call(harness.host_stream(src, dst, w, args.device))
        del src, dst, w
    for seed in args.seeds:
        for row in readings(cell, seed, args.device, args.program, call):
            print(json.dumps(harness.finite(row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
