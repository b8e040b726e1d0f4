"""Rules of the port: it stands alone (no JAX, nothing of ``repro``), runs on
the card unless asked for the CPU, never falls back, and says so where a
part is not ported yet."""
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import SnapshotManager
from repro_torch.core import (
    EdgeStream,
    ExecutionGuard,
    SubstreamConfig,
    gseq,
    mwm_pipeline,
    mwm_rounds,
    mwm_rounds_sharded,
    substream_matchings,
)
from repro_torch.distributed import build_mesh, plan_remesh
from repro_torch.graph import coarsen_by_matching
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    L2_BYTES,
    device_plan,
    match_epochs,
    merge_device,
    substream_match,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
#: an import of jax or of the JAX package (``repro`` but not ``repro_torch``)
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b(?!_)", re.M)


def test_port_files_import_neither_jax_nor_repro():
    assert len(PORT_FILES) > 10 and PORT_FILES[-1].exists()
    offenders = {
        str(p.relative_to(ROOT)): FORBIDDEN.findall(p.read_text()) for p in PORT_FILES
    }
    assert {k: v for k, v in offenders.items() if v} == {}


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'repro.')) or k == 'repro')\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _cpu_stream():
    return EdgeStream.from_numpy([0, 1], [1, 2], [2.0, 3.0], device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, ``device=None`` raises: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream, cfg = _cpu_stream(), SubstreamConfig(n=3, L=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        substream_match(stream, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mwm_pipeline(stream, cfg, part1="kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        substream_match(stream, cfg, schedule="mega")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeStream.from_numpy([0], [1], [1.0])


@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_unpacked_runs_on_the_cpu_when_asked(schedule):
    """The unpacked layout is ported: with ``device="cpu"`` it runs the
    plain versions and returns dense bits."""
    cfg = SubstreamConfig(n=3, L=8, mb_layout="unpacked")
    r = substream_match(_cpu_stream(), cfg, schedule=schedule, device="cpu")
    assert not r.is_packed and r.mb.dtype == torch.bool
    assert r.assigned.tolist() == [7, -1]


def test_unpacked_and_epochs_default_to_the_card(monkeypatch):
    """Without a card, ``device=None`` raises for the unpacked layout and for
    the epoch executor too: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = _cpu_stream()
    cfg = SubstreamConfig(n=3, L=8, mb_layout="unpacked")
    for schedule in ("edges", "waves", "mega"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            substream_match(stream, cfg, schedule=schedule)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mwm_pipeline(stream, SubstreamConfig(n=3, L=8), part1="kernel", packed=False)
    for engine in ("edges", "scan"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            match_epochs(stream, cfg, epochs=2, engine=engine)


NEW_ENTRIES = {
    "merge_device": lambda s, c, tmp: merge_device(s, substream_match(s, c, device="cpu"), c),
    "substream_match_fallback": lambda s, c, tmp: substream_match(s, c, on_plan_failure="fallback"),
    "substream_match_validate": lambda s, c, tmp: substream_match(s, c, validate="strict"),
    "match_epochs_snapshots": lambda s, c, tmp: match_epochs(
        s, c, engine="scan", snapshots=SnapshotManager(tmp)),
    "match_epochs_guard": lambda s, c, tmp: match_epochs(
        s, c, engine="edges", guard=ExecutionGuard(), on_plan_failure="fallback"),
}


@pytest.mark.parametrize("entry", sorted(NEW_ENTRIES))
def test_robustness_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """The robustness layers add no CPU fallback: ``device=None`` raises
    without a card, and nothing was written."""
    stream, cfg = _cpu_stream(), SubstreamConfig(n=3, L=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NEW_ENTRIES[entry](stream, cfg, tmp_path)
    assert not list(tmp_path.glob("step_*"))


SLICE_ENTRIES = {
    "mwm_rounds": lambda s, c: mwm_rounds(s, c),
    "mwm_pipeline_rounds": lambda s, c: mwm_pipeline(s, c, part1="rounds"),
    "mwm_rounds_sharded": lambda s, c: mwm_rounds_sharded(s, c, types.SimpleNamespace(
        device_type="cuda", get_group=lambda axis: pytest.fail("touched the mesh"))),
    "build_mesh": lambda s, c: build_mesh(plan_remesh(1)),
    "substream_matchings": lambda s, c: substream_matchings(s, c),
    "gseq": lambda s, c: gseq(s, c.n),
    "coarsen_by_matching": lambda s, c: coarsen_by_matching([0, 1], [1, 2], [2.0, 3.0], 3),
}


@pytest.mark.parametrize("entry", sorted(SLICE_ENTRIES))
def test_rounds_gseq_and_substrate_default_to_the_card(monkeypatch, entry):
    """The rounds engines, G-SEQ, ``substream_matchings``, coarsening and
    the mesh: ``device=None`` (for the sharded rounds, a mesh on the card)
    raises without a card, before any work."""
    stream, cfg = _cpu_stream(), SubstreamConfig(n=3, L=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLICE_ENTRIES[entry](stream, cfg)


def test_unported_layout_and_engines_raise():
    stream = _cpu_stream()
    with pytest.raises(ValueError, match="mb_layout"):
        SubstreamConfig(n=3, L=8, mb_layout="dense")
    with pytest.raises(ValueError):
        mwm_pipeline(stream, SubstreamConfig(n=3, L=8), part1="pallas", device="cpu")


def test_device_plan():
    plan = device_plan(2**20, 64)  # the paper's configuration
    assert (plan.n_pad, plan.width, plan.words, plan.nbytes) == (2**20, 8, 8, 8 * 2**20)
    assert plan.fits_l2 and plan.nbytes <= L2_BYTES
    plan = device_plan(257, 300)
    assert (plan.n_pad, plan.width, plan.words) == (264, 40, 38)
    assert not device_plan(2**23, 64).fits_l2
    with pytest.raises(ValueError, match="free on the card"):
        device_plan(2**20, 64, free_bytes=2**20)


def test_kernel_wrapper_checks_operands():
    edges = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    w = torch.tensor([2.0, 3.0])
    thr = torch.full((8, 8), float("inf"))
    thr[0, 0] = 1.0
    assigned, mb = kernel.substream_match_packed(edges, w, thr, 8)  # CPU: plain version
    assert assigned.tolist() == [0, -1] and mb.shape == (8, 8)
    assert mb[:3, 0].tolist() == [1, 1, 0]
    with pytest.raises(ValueError, match="edges"):
        kernel.substream_match_packed(edges.long(), w, thr, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.substream_match_packed(edges, w, thr.T.contiguous().T, 8)
    with pytest.raises(ValueError, match="mb_init"):
        kernel.substream_match_packed(edges, w, thr, 8, mb_init=torch.zeros((4, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="outside"):
        kernel.substream_match_packed(edges, w, thr, 2)
    with pytest.raises(ValueError, match="outside"):
        kernel.substream_match_packed(-edges, w, thr, 8)


def test_invalid_edges_with_wild_ids_never_match():
    """Padding edges may hold any ids: they enter the kernel as vertex 0
    with weight 0 and change nothing."""
    stream = EdgeStream(
        src=torch.tensor([0, -7, 1], dtype=torch.int32),
        dst=torch.tensor([1, 99, 2], dtype=torch.int32),
        weight=torch.tensor([2.0, 5.0, 3.0]),
        valid=torch.tensor([True, False, True]),
    )
    r = substream_match(stream, SubstreamConfig(n=3, L=8), device="cpu")
    assert r.assigned.tolist() == [7, -1, -1]
    np.testing.assert_array_equal(r.mb.numpy()[:, 7], [True, True, False])
