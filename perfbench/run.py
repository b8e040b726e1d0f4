"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and the numbers that decided ``correct`` beside their limits as the last
lines of standard error. Exits with 1, printing no result, without enough
CUDA devices for the cell, when the program under test is not beside the
benchmark, or when JAX or the JAX package was loaded.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache stays inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program under test (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROC0)
    # after the window, the reference and every metric reader: what the run loaded
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 1
    print(json.dumps(harness.finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
