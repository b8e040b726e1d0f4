"""Nothing the benchmark runs loads JAX or the JAX package ``repro``: top-level
module names are compared whole, so ``repro_torch`` passes."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

from perfbench import harness

BENCH = pathlib.Path(harness.ROOT) / "perfbench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "reproduce", "benchmarks_torch"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax._src", "jaxlib", "flax", "benchmarks.bench_throughput"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    seen = {}
    for path in sorted(BENCH.rglob("*.py")):
        for name in _top_level_imports(path):
            seen.setdefault(name, path)
    assert seen, "walked no file"
    bad = harness.forbidden_modules(seen)
    assert not bad, {b: str(seen[b]) for b in bad}


def test_what_the_benchmark_runs_loads_no_jax():
    """Import every module a run loads (harness, readers, generators, the
    program's entry points) in a fresh process and list its modules."""
    code = f"""
import sys, pathlib
sys.path[:0] = [{str(harness.ROOT / 'src')!r}, {str(harness.ROOT)!r}]
from perfbench import harness, control
root = pathlib.Path({str(harness.ROOT)!r}) / "perfbench"
for sub in ("metrics", "gen"):
    for p in sorted((root / sub).glob("*.py")):
        harness.load_module(p, p.stem)
harness.job_fn(harness.Cell("kron48.s16-jobs"), "cpu")
import repro_torch.core, repro_torch.kernels.substream_match.ops, repro_torch.kernels.build
print(",".join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip().split(",")
    assert "repro_torch" in out and "torch" in out
    assert harness.forbidden_modules(out) == []


@pytest.mark.parametrize("loaded", ["jax", "benchmarks.bench_throughput", "repro.core"])
def test_command_prints_no_result_when_the_run_loaded_jax(monkeypatch, capsys, loaded):
    """The look at ``sys.modules`` comes after the whole run, the reference
    and the metric readers with it: what any of them loads is caught."""
    import types

    import torch

    from perfbench import run

    runs = []

    def loads_it(*a, **k):  # as a reference or a reader that imports it would
        if not runs:
            monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
        runs.append(1)
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", loads_it)
    argv = ["--workload", "kron48.s20", "--seed", "1", "--seconds", "1"]
    assert run.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and loaded.split(".")[0] in out.err
    monkeypatch.delitem(sys.modules, loaded)
    assert run.main(argv) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"] is True
