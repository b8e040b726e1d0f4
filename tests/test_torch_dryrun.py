"""The dry-run tooling of the port, held to the JAX package's.

* ``arch_rules``, ``build_step`` (argument shapes and dtypes, argument and
  output placements, ``donate``, ``kind``) and ``useful_flops`` equal the
  reference's for every arch x shape x {pod, multi-pod} case;
* ``roofline_terms`` equals the reference's with its three constants set
  to the H100's (a patch of the reference module inside the test);
* the collective formulas agree with the reference's
  ``collective_bytes_from_hlo`` on HLO lines written from the collectives a
  trace recorded, and a known redistribute on a fake 16x16 world moves the
  analytic bytes; a product split 16 ways counts a sixteenth of the FLOPs;
* an LM step's peak, extrapolated in L from 2 and 3 layers, equals the
  traced peak at 4 and 6 layers on the smoke configs, and its FLOPs,
  bytes and collectives the traced step's at 4, its parts adding up to
  them;
* ``report`` renders the reference's text, character for character, on a
  fixture with an error cell.

The fake worlds (``launch/mesh.py::fake_world``) live in this process for
one test each; nothing here runs on a card or a real process group.
"""
import dataclasses
import json

import jax
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

import repro.configs.registry as jregistry
import repro.launch.report as jreport
import repro.launch.roofline as jroofline
import repro.launch.steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import components, dryrun, report, roofline, steps
from repro_torch.launch.components import LocalCosts
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.param import PSpec

CASES = [(a, s) for a in jregistry.all_arch_ids() for s in jregistry.get_arch(a).shapes]
MESHES = pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])


def _cell(arch_id, shape_name):
    jarch = jregistry.get_arch(arch_id)
    arch = get_arch(arch_id)
    return jarch, jarch.shapes[shape_name], arch, arch.shapes[shape_name]


def _flat_port(tree, prefix=""):
    """{path: leaf} of a port tree: PSpec as its tuple, a tensor as (shape, dtype)."""
    if isinstance(tree, PSpec):
        return {prefix: tuple(tree)}
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _flat_reference(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (PartitionSpec, jax.ShapeDtypeStruct)))[0]
    out = {}
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype)) if isinstance(
            leaf, jax.ShapeDtypeStruct) else tuple(leaf)
    return out


@MESHES
@pytest.mark.parametrize("arch_id, shape_name", CASES)
def test_arch_rules_match_reference(arch_id, shape_name, multi_pod):
    jarch, jshape, arch, shape = _cell(arch_id, shape_name)
    assert steps.arch_rules(arch, shape, multi_pod) == jsteps.arch_rules(jarch, jshape, multi_pod)


@MESHES
@pytest.mark.parametrize("arch_id, shape_name", CASES)
def test_build_step_matches_reference(arch_id, shape_name, multi_pod):
    """Every argument's shape, dtype and placement, the outputs' placements,
    ``donate`` and ``kind`` of the port's step are the reference's."""
    jarch, jshape, arch, shape = _cell(arch_id, shape_name)
    want = jsteps.build_step(jarch, jshape, multi_pod=multi_pod)
    got = steps.build_step(arch, shape, multi_pod=multi_pod, device="meta")
    assert got.kind == want.kind and got.donate == want.donate
    assert got.rules == want.rules
    assert [_flat_port(t) for t in got.arg_specs] == [_flat_reference(t) for t in want.arg_specs]
    assert all(t.device.type == "meta" for a in got.arg_specs
               for t in jax.tree_util.tree_leaves(a))
    assert [_flat_port(t) for t in got.arg_pspecs] == [_flat_reference(t) for t in want.arg_pspecs]
    assert _flat_port(got.out_pspecs) == _flat_reference(want.out_pspecs)


@MESHES
@pytest.mark.parametrize("arch_id, shape_name",
                         [c for c in CASES if jregistry.get_arch(c[0]).family == "lm"])
def test_lm_shape_config_matches_reference_on_either_mesh(arch_id, shape_name, multi_pod):
    """Two pods dispatch the MoE tokens in 32 groups (the data-parallel
    shards), one pod in 16."""
    jarch, jshape, arch, shape = _cell(arch_id, shape_name)
    got = steps.lm_shape_config(arch, shape, multi_pod)
    want = jsteps._lm_shape_overrides(jarch.config, jshape, multi_pod=multi_pod)
    fields = ("moe_groups", "attn_chunk", "attn_par", "loss_chunk", "remat")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


@pytest.mark.parametrize("arch_id, shape_name", CASES)
def test_useful_flops_match_reference(arch_id, shape_name):
    jarch, jshape, arch, shape = _cell(arch_id, shape_name)
    assert roofline.useful_flops(arch, shape) == jroofline.useful_flops(jarch, jshape)


RECORDS = [
    {"flops_per_device": 3.9e15, "bytes_per_device": 2.1e13,
     "collectives": {"total_bytes_per_device": 4.4e11}, "model_flops": 6.1e17, "n_chips": 256},
    {"flops_per_device": 1.2e12, "bytes_per_device": 8.8e12,
     "collectives": {"total_bytes_per_device": 1e9}, "model_flops": 2e14, "n_chips": 512},
    {"flops_per_device": 5e11, "bytes_per_device": 1e9,
     "collectives": {"total_bytes_per_device": 7e11}, "model_flops": 0, "n_chips": 256},
    {"flops_per_device": 0, "bytes_per_device": 0, "n_chips": 1},
]


@pytest.mark.parametrize("rec", RECORDS)
def test_roofline_terms_match_reference_at_h100_constants(monkeypatch, rec):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, name, getattr(roofline, name))
    assert roofline.roofline_terms(rec) == jroofline.roofline_terms(rec)


def test_h100_constants():
    """bf16 dense peak and HBM3 rate of the data sheet; the link figure is
    the inter-host InfiniBand port that bounds a 16-wide axis."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)


# ------------------------------------------------------------ collectives


def _mesh16():
    return DeviceMesh("cuda", torch.arange(256).reshape(16, 16), mesh_dim_names=("data", "model"))


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_known_redistribute_moves_the_analytic_bytes():
    """[1024, 1024] float32 split over data, gathered whole: one all-gather of
    a 4 MiB result over 16 ranks, each moving 15/16 of it."""
    with fake_world(256):
        mesh = _mesh16()
        x = distribute_tensor(_meta(1024, 1024), mesh, [Shard(0), Replicate()], src_data_rank=None)
        costs = LocalCosts()
        with costs:
            x.redistribute(mesh, [Replicate(), Replicate()])
    assert costs.collectives == [("all-gather", 4 << 20, 16)]
    assert costs.collective_totals() == {"all-gather": (4 << 20) * 15 / 16,
                                         "total_bytes_per_device": (4 << 20) * 15 / 16, "n_ops": 1}


def test_collective_formulas_match_reference_on_hlo():
    """Each kind a DTensor issues, priced by the port and by the reference's
    HLO parser on lines written from the same records."""
    with fake_world(256):
        mesh = _mesh16()
        costs = LocalCosts()
        x = distribute_tensor(_meta(512, 256), mesh, [Shard(0), Shard(1)], src_data_rank=None)
        partial = lambda place: DTensor.from_local(_meta(64, 96), mesh, place, run_check=False)
        with costs:
            x.redistribute(mesh, [Replicate(), Replicate()])  # all-gathers
            y = distribute_tensor(_meta(512, 256), mesh, [Shard(0), Replicate()], src_data_rank=None)
            y.redistribute(mesh, [Shard(1), Replicate()])  # an all-to-all
            partial([Partial(), Replicate()]).redistribute(mesh, [Replicate(), Replicate()])
            partial([Replicate(), Partial()]).redistribute(mesh, [Replicate(), Shard(0)])
    kinds = {k for k, _, _ in costs.collectives}
    assert kinds == {"all-gather", "all-to-all", "all-reduce", "reduce-scatter"}
    hlo = "\n".join(f"  %c{i} = u8[{n}]{{0}} {kind}(u8[1] %p), replica_groups=[{256 // g},{g}]<=[256]"
                    for i, (kind, n, g) in enumerate(costs.collectives))
    assert costs.collective_totals() == jroofline.collective_bytes_from_hlo(hlo)


def test_flops_count_a_ranks_share():
    """A product split 16 ways over the model axis counts a sixteenth of the
    same product's FLOPs where nothing is split."""
    with fake_world(256):
        mesh = _mesh16()
        b = distribute_tensor(_meta(512, 256), mesh, [Replicate(), Replicate()], src_data_rank=None)
        counts = []
        for place in ([Replicate(), Shard(0)], [Replicate(), Replicate()]):
            a = distribute_tensor(_meta(1024, 512), mesh, place, src_data_rank=None)
            costs = LocalCosts()
            with costs:
                a @ b
            counts.append(costs.flops)
    assert counts == [2 * 64 * 512 * 256, 2 * 1024 * 512 * 256]


def test_production_mesh_spans_the_fake_world():
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.shape == (2, 16, 16) and mesh.mesh_dim_names == ("pod", "data", "model")
    with fake_world(256):
        mesh = make_production_mesh()
        assert mesh.shape == (16, 16) and mesh.device_type == "cuda"
    with fake_world(4), pytest.raises(RuntimeError, match="already initialised"):
        with fake_world(4):
            pass


# ------------------------------------------------------------ memory


@pytest.mark.parametrize("arch_id, kind, rules_shape", [
    ("gemma-7b", "train", "train_4k"), ("moonshot-v1-16b-a3b", "train", "train_4k"),
    ("minicpm-2b", "decode", "decode_32k"), ("gemma-7b", "prefill", "prefill_32k"),
])
@pytest.mark.parametrize("depth", [4, 6])
def test_peak_extrapolated_in_depth_equals_the_traced_peak(arch_id, kind, rules_shape, depth):
    """``lm_peak`` traces 2 and 3 layers and extrapolates each phase's peak
    linearly; a whole step traced at ``depth`` layers peaks at that value."""
    full = get_arch(arch_id)
    arch = dataclasses.replace(full, config=dataclasses.replace(
        full.smoke_config, n_layers=depth, vocab_pad_to=8))
    shape = ShapeSpec("small", kind, seq_len=64, global_batch=4)
    rules = steps.arch_rules(full, full.shapes[rules_shape], False)
    with fake_world(4):
        mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        peak = dryrun.lm_peak(arch, shape, mesh, False, rules)
        traced = dryrun.trace_step(steps.build_step(arch, shape, device="meta", rules=rules),
                                   arch, shape, mesh)
    assert sorted(peak["traces"]) == list(dryrun.PEAK_DEPTHS)
    assert peak["peak"] == traced["peak_bytes"]
    assert peak["argument"] == traced["argument_bytes"]


@pytest.mark.parametrize("arch_id, kind, rules_shape", [
    ("gemma-7b", "train", "train_4k"), ("minicpm-2b", "train", "train_4k"),
    ("moonshot-v1-16b-a3b", "train", "train_4k"), ("grok-1-314b", "train", "train_4k"),
    ("internlm2-20b", "train", "train_4k"), ("minicpm-2b", "prefill", "prefill_32k"),
    ("gemma-7b", "decode", "decode_32k"),
])
def test_lm_costs_add_up_to_the_traced_step(arch_id, kind, rules_shape):
    """An LM cell's FLOPs, bytes and collectives, extrapolated in L from
    whole steps of 2 and 3 layers, equal a whole step traced at 4; its
    ``parts`` (the isolated components, then ``layer_rest`` and ``rest``)
    add up to them (so the gradients' reductions onto the parameters'
    layout, which the isolated layer does not issue, are counted)."""
    full = get_arch(arch_id)
    arch = dataclasses.replace(full, config=dataclasses.replace(
        full.smoke_config, n_layers=4, vocab_pad_to=8))
    shape = ShapeSpec("small", kind, seq_len=64, global_batch=4)
    rules = steps.arch_rules(full, full.shapes[rules_shape], False)
    with fake_world(4):
        mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        parts = components.lm_component_costs(arch, shape, mesh, False, rules=rules)
        peak = dryrun.lm_peak(arch, shape, mesh, False, rules)
        total, extra = dryrun.lm_costs(parts, peak["traces"], 4)
        traced = dryrun.trace_step(steps.build_step(arch, shape, device="meta", rules=rules),
                                   arch, shape, mesh)
    assert total == {k: traced[k] for k in dryrun.COSTS}
    assert extra["collectives"] == traced["collectives"]
    parts = extra["parts"]
    assert set(parts) >= {"layer", "layer_rest", "rest"} and parts["layer"]["mult"] == 4
    for k in dryrun.COSTS:
        assert sum(c.get("mult", 1) * c[k] for c in parts.values()) == pytest.approx(
            total[k], rel=1e-12)


# ------------------------------------------------------------ report


def _record(arch, shape, mesh, peak_gib, dominant):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_chips": 256, "kind": "train",
            "lower_s": 0.12, "compile_s": 3.4567, "memory": {"peak_per_device": peak_gib * 2**30},
            "model_flops": 1.23e17,
            "roofline": {"compute_s": 0.0123, "memory_s": 4.56, "collective_s": 7.891e-4,
                         "dominant": dominant, "step_time_lower_bound_s": 4.56,
                         "useful_flop_ratio": 0.7654, "roofline_fraction": 0.0321}}


def test_report_renders_the_reference_text(tmp_path):
    data = {
        "a|s|single": _record("gemma-7b", "train_4k", "16x16", 6.3, "memory_s"),
        "a|s|multi": _record("gemma-7b", "train_4k", "2x16x16", 3.2, "collective_s"),
        "b|s|single": {**_record("gin-tu", "molecule", "16x16", 0.0, "compute_s"),
                       "roofline": {"compute_s": 1e-6, "memory_s": 0.0, "collective_s": 0.0,
                                    "dominant": "compute_s", "step_time_lower_bound_s": 1e-6}},
        "c|s|single": {"arch": "grok-1-314b", "shape": "decode_32k", "mesh": "16x16",
                       "error": "RuntimeError: " + "x" * 100, "traceback": "..."},
        "c|s|multi": {"arch": "grok-1-314b", "shape": "decode_32k", "mesh": "2x16x16",
                      "error": "ValueError: no"},
    }
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(data))
    for mesh in ("16x16", "2x16x16"):
        assert report.render_table(str(path), mesh) == jreport.render_table(str(path), mesh)
    assert report.render_multipod_check(str(path)) == jreport.render_multipod_check(str(path))
    assert "ERROR: RuntimeError" in report.render_table(str(path))
