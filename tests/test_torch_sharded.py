"""Port parity of the distributed rounds and the elastic mesh plan.

``mwm_rounds_sharded`` runs on gloo meshes of CPU processes (spawned,
joined within 60 s) and must return, on every rank, the JAX package's
``mwm_rounds`` result; on a (2, 2) mesh it must also equal the JAX
package's own ``mwm_rounds_sharded`` on four forced host devices, run in a
subprocess (60 s). ``plan_remesh`` must equal the reference's."""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.core as jcore
from repro.core.rounds import mwm_rounds as j_mwm_rounds
from repro.distributed.elastic import plan_remesh as j_plan_remesh
from repro_torch.distributed import plan_remesh
from repro_torch.testing.cases import rmat_case
from repro_torch.testing.sharded import run_sharded

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 60

JAX_SHARDED = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.core as jcore
from repro.core.rounds import mwm_rounds_sharded
a = np.load(sys.argv[1])
stream = jcore.EdgeStream(*(jnp.asarray(a[k]) for k in ("src", "dst", "weight", "valid")))
cfg = jcore.SubstreamConfig(n=int(a["n"]), L=int(a["L"]), eps=float(a["eps"]))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
assigned, mb = mwm_rounds_sharded(stream, cfg, mesh)
np.savez(sys.argv[2], assigned=np.asarray(assigned), mb=np.asarray(mb),
         thresholds=np.asarray(cfg.thresholds()))
"""


@pytest.fixture
def jax_sharded(tmp_path):
    """Run the JAX package's ``mwm_rounds_sharded`` on the saved inputs on a
    (2, 2) mesh of forced host devices; returns its arrays."""
    def run(inputs):
        ref = tmp_path / "reference.npz"
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        subprocess.run([sys.executable, "-c", JAX_SHARDED, str(inputs), str(ref)], env=env,
                       check=True, timeout=TIMEOUT, capture_output=True)
        return np.load(ref)
    return run


@pytest.mark.parametrize("prefer_model", [1, 4, 16])
@pytest.mark.parametrize("n", list(range(1, 65)))
def test_plan_remesh_matches_reference(n, prefer_model):
    got = plan_remesh(n, prefer_model=prefer_model)
    want = j_plan_remesh(n, prefer_model=prefer_model)
    assert (got.data, got.model, got.pod, got.dropped_devices, got.n_devices) == (
        want.data, want.model, want.pod, want.dropped_devices, want.n_devices)


def _inputs(tmp_path, scale, L, seed, multiple=8, thresholds=None):
    """The case as the reference's padded stream (m a multiple of
    ``multiple``), saved for the ranks, and the reference's ``mwm_rounds``."""
    c = rmat_case(scale, edge_factor=4, L=L, seed=seed)
    m_pad = -(-(c.src.shape[0] + 3) // multiple) * multiple
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=L, eps=c.eps)
    thr = np.asarray(jax.jit(jcfg.thresholds)()) if thresholds is None else thresholds
    path = tmp_path / "inputs.npz"
    np.savez(path, src=np.asarray(js.src), dst=np.asarray(js.dst), weight=np.asarray(js.weight),
             valid=np.asarray(js.valid), n=c.n, L=L, eps=c.eps, thresholds=thr)
    return path, j_mwm_rounds(js, jcfg)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_sharded_rounds_match_reference_rounds(tmp_path, shape):
    path, want = _inputs(tmp_path, scale=8, L=16, seed=sum(shape) + shape[0])
    results = run_sharded(shape, path, tmp_path / "out", timeout=TIMEOUT)
    assert len(results) == shape[0] * shape[1]
    for assigned, mb in results:  # every rank holds the whole result
        assert assigned.dtype == np.int32 and mb.dtype == np.bool_
        np.testing.assert_array_equal(assigned, np.asarray(want.assigned))
        np.testing.assert_array_equal(mb, np.asarray(want.mb))


def test_sharded_rounds_match_reference_sharded(tmp_path, jax_sharded):
    """The JAX package's own ``mwm_rounds_sharded`` on a (2, 2) mesh of
    forced host devices (its thresholds computed eagerly, as it does)."""
    path, _ = _inputs(tmp_path, scale=9, L=16, seed=7)
    want = jax_sharded(path)
    path, _ = _inputs(tmp_path, scale=9, L=16, seed=7, thresholds=want["thresholds"])
    results = run_sharded((2, 2), path, tmp_path / "out", timeout=TIMEOUT)
    for assigned, mb in results:
        np.testing.assert_array_equal(assigned, want["assigned"])
        np.testing.assert_array_equal(mb, want["mb"])


@pytest.mark.parametrize("shape, multiple, L, match", [
    ((2, 1), 1, 16, "m % data == 0"),
    ((1, 2), 8, 13, "L % model == 0"),
])
def test_sharded_rounds_refuse_uneven_shards(tmp_path, shape, multiple, L, match):
    path, _ = _inputs(tmp_path, scale=6, L=L, seed=1, multiple=multiple)
    a = dict(np.load(path))
    if a["src"].shape[0] % 2 == 0:  # make m odd
        for k in ("src", "dst", "weight", "valid"):
            a[k] = a[k][:-1]
        np.savez(path, **a)
    with pytest.raises(RuntimeError, match=match):
        run_sharded(shape, path, tmp_path / "out", timeout=TIMEOUT)


def test_reference_sharded_reads_other_thresholds(tmp_path, jax_sharded):
    """A fault of the reference, pinned (ROADMAP.md §3): its
    ``mwm_rounds_sharded`` reads the eagerly computed thresholds, its
    ``mwm_rounds`` the jitted ones; at L = 64 they differ in lane 56, so
    on a weight between the two values the two engines disagree. The
    port's engines read one vector and agree."""
    jcfg = jcore.SubstreamConfig(n=8, L=64, eps=0.1)
    eager, jitted = np.asarray(jcfg.thresholds()), np.asarray(jax.jit(jcfg.thresholds)())
    assert np.nonzero(eager != jitted)[0].tolist() == [56]
    w = np.full(4, min(eager[56], jitted[56]), np.float32)
    js = jcore.EdgeStream.from_numpy(np.array([0, 2, 4, 6]), np.array([1, 3, 5, 7]), w)
    path = tmp_path / "inputs.npz"
    np.savez(path, src=np.asarray(js.src), dst=np.asarray(js.dst), weight=np.asarray(js.weight),
             valid=np.asarray(js.valid), n=8, L=64, eps=0.1, thresholds=jitted)
    rounds = np.asarray(j_mwm_rounds(js, jcfg).assigned)
    sharded = jax_sharded(path)["assigned"]
    assert rounds.tolist() == [56] * 4 and sharded.tolist() == [55] * 4
    for assigned, _ in run_sharded((2, 2), path, tmp_path / "out", timeout=TIMEOUT):
        np.testing.assert_array_equal(assigned, rounds)
