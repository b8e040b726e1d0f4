"""The port's matching examples and its ``minihyp``, held to the JAX package.

* ``repro_torch.launch.quickstart`` and ``repro_torch.launch.matching_e2e``
  on the CPU (``device="cpu"``: the packed per-edge kernel's plain version)
  at small scales: their matched edges and weights equal the reference's
  ``mwm_pipeline`` and ``mwm_blocked(backend="scan")`` + ``merge_host`` on
  the same stream (the blocked order through the kernel computes what the
  blocked order through CS-SEQ does; the reference's Pallas variants do not
  trace on the installed jax), exactly; the exact MWM and the ratio too.
  The port's thresholds equal the reference's jitted ones at these configs
  (checked: the hazard of ROADMAP.md §3 is in other lanes).
* ``repro_torch.testing.minihyp`` draws exactly what the reference shim
  draws for the same test name and example index, strategy by strategy.
"""
import sys

import jax
import numpy as np
import pytest

import repro.core as jcore
from repro.graph.csr import CSRGraph as JCSRGraph
from repro.graph.csr import CustomCSR as JCustomCSR
from repro.graph.generators import kronecker_graph as j_kronecker_graph
from repro.graph.generators import uniform_weights as j_uniform_weights
from repro.testing import minihyp as jminihyp
from repro_torch.launch import matching_e2e, quickstart
from repro_torch.testing import minihyp


def _thresholds_agree(L, eps):
    from repro_torch.core import SubstreamConfig

    want = np.asarray(jax.jit(jcore.SubstreamConfig(n=8, L=L, eps=eps).thresholds)())
    np.testing.assert_array_equal(np.asarray(SubstreamConfig(n=8, L=L, eps=eps).thresholds()),
                                  want)


@pytest.mark.parametrize("scale", [7, 8])
def test_quickstart_matches_reference(scale, capsys):
    L, eps = 16, 0.1
    _thresholds_agree(L, eps)
    got = quickstart.run(device="cpu", scale=scale, L=L, eps=eps)
    assert "guarantee" in capsys.readouterr().out
    src, dst = j_kronecker_graph(scale=scale, edge_factor=8, seed=0)
    stream = jcore.EdgeStream.from_numpy(src, dst, j_uniform_weights(len(src), L, eps, seed=0))
    cfg = jcore.SubstreamConfig(n=1 << scale, L=L, eps=eps)
    # the port's "kernel" variant is the blocked order through the kernel:
    # the reference's "blocked" computes the same
    for variant, ref in (("scan", "scan"), ("blocked", "blocked"), ("rounds", "rounds"),
                         ("kernel", "blocked")):
        idx, weight = jcore.mwm_pipeline(stream, cfg, part1=ref)
        assert got["variants"][variant]["matched"] == len(idx), variant
        assert got["variants"][variant]["weight"] == weight, variant
    idx, weight = jcore.mwm_pipeline(stream, cfg)
    exact = jcore.exact_mwm_weight(stream)
    assert (got["weight"], got["exact"]) == (weight, exact)
    assert got["ratio"] == exact / weight <= 4 + eps
    assert got["plan"]["fits_l2"] and got["plan"]["width"] == 8


@pytest.mark.parametrize("scale, L", [(8, 32), (9, 16)])
def test_matching_e2e_matches_reference(scale, L, tmp_path, capsys):
    eps, K = 0.1, 32
    _thresholds_agree(L, eps)
    got = matching_e2e.run(device="cpu", scale=scale, L=L, eps=eps, K=K,
                           ckpt_dir=str(tmp_path / "ckpt"))
    assert "merge reproduced exactly" in capsys.readouterr().out
    n = 1 << scale
    src, dst = j_kronecker_graph(scale, 16, seed=0)
    csr = JCSRGraph.from_edges(src, dst, j_uniform_weights(len(src), L, eps, seed=0), n=n)
    custom = JCustomCSR.encode(csr)
    stream = jcore.EdgeStream.from_numpy(*custom.decode().to_stream_arrays())
    cfg = jcore.SubstreamConfig(n=n, L=L, eps=eps)
    res = jcore.mwm_blocked(stream, cfg, K=K, backend="scan")
    idx = jcore.merge_host(stream, res, cfg)
    weight = jcore.matching_weight(stream, idx)
    exact = jcore.exact_mwm_weight(stream)
    assert (got["m"], got["dram_bytes"]) == (csr.m, custom.dram_bytes)
    assert (got["matched"], got["weight"], got["exact"]) == (len(idx), weight, exact)
    assert got["ratio"] <= 4 + eps and got["restart_step"] == 1
    assert (tmp_path / "ckpt" / "step_00000001" / "part1.npz").exists()


# ------------------------------------------------------------------ minihyp


def _strategies(st):
    """Strategies of each kind, built from the shim ``st``."""
    return {
        "integers": (st.integers(-5, 1000),),
        "floats": (st.floats(0.5, 2.5),),
        "booleans": (st.booleans(),),
        "sampled_from": (st.sampled_from(["a", "b", "c", "d"]),),
        "tuples": (st.tuples(st.integers(0, 9), st.floats(0.0, 1.0)),),
        "lists": (st.lists(st.integers(0, 3), min_size=1, max_size=6),),
        "builds": (st.builds(lambda a, b=0: (a, b), st.integers(0, 9), b=st.integers(10, 19)),),
        "just": (st.just(7), st.integers(0, 1)),
        "map_filter": (st.integers(0, 100).map(lambda x: 2 * x).filter(lambda x: x % 3),),
    }


def _record(mod, name, n):
    """The arguments ``mod.given`` passes a test named ``name`` over ``n``
    examples."""
    seen = []

    def body(*args):
        seen.append(args)

    body.__qualname__ = name
    mod.given(*_strategies(mod)[name])(mod.settings(max_examples=n)(body))()
    return seen


@pytest.mark.parametrize("name", sorted(_strategies(minihyp)))
def test_minihyp_draws_equal_the_reference_shim(name):
    got, want = _record(minihyp, name, 25), _record(jminihyp, name, 25)
    assert len(got) == 25 and got == want


def test_minihyp_data_assume_and_failures_as_the_reference():
    def run(mod):
        drawn, failures = [], []

        @mod.given(mod.data(), mod.integers(0, 9))
        @mod.settings(max_examples=30)
        def prop(data, x):
            mod.assume(x != 3)
            drawn.append((x, data.draw(mod.floats(0.0, 1.0)), data.draw(mod.integers(0, 5))))
            assert x < 8

        with pytest.raises(AssertionError) as err:
            prop()
        failures.append(str(err.value).split(":")[0])
        return drawn, failures

    (got, got_f), (want, want_f) = run(minihyp), run(jminihyp)
    assert got == want and got_f == want_f and all(x != 3 for x, *_ in got)


def test_minihyp_install_registers_the_shim(monkeypatch):
    for name in ("hypothesis", "hypothesis.strategies"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    minihyp.install()
    hyp, st = sys.modules["hypothesis"], sys.modules["hypothesis.strategies"]
    assert hyp.__version__ == "0.0-minihyp" and hyp.given is minihyp.given
    assert st.integers is minihyp.integers and hyp.strategies is st
    minihyp.install()  # a second call keeps the first
    assert sys.modules["hypothesis"] is hyp
