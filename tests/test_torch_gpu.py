"""Card-only tests of the port: the CUDA kernels against their plain
versions, and the main path on the card against the same path on the CPU. They skip
without a CUDA device; on a machine with an NVIDIA card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    kernel_inputs,
    mega_inputs,
    resolve_stream_schedule,
    waves_inputs,
)
from repro_torch.testing.cases import ZOO, rmat_case

pytestmark = pytest.mark.gpu

CASES = {**ZOO,
         "rmat10_L64": lambda: rmat_case(10, edge_factor=4, L=64, pad=3),
         "rmat10_L300": lambda: rmat_case(10, edge_factor=4, L=300, eps=0.01)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _on(case, device):
    stream = EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad, device=device)
    return stream, SubstreamConfig(n=case.n, L=case.L, eps=case.eps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case):
    args = kernel_inputs(*_on(CASES[case](), cuda))
    before = build.launches[kernel.NAME]
    assigned, mb = kernel.substream_match_packed(*args)
    assert build.launches[kernel.NAME] == before + 1
    want_a, want_mb = kernel.substream_match_packed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


def _wave_operands(schedule, stream, cfg, seg_block):
    sch = resolve_stream_schedule(stream)
    if schedule == "mega":
        args, _ = mega_inputs(stream, cfg, sch, seg_block)
        return kernel.MEGA_NAME, kernel.substream_match_mega, kernel.substream_match_mega_plain, args
    args, _ = waves_inputs(stream, cfg, sch)
    return kernel.WAVES_NAME, kernel.substream_match_waves, kernel.substream_match_waves_plain, args


@pytest.mark.parametrize("schedule, seg_block", [("mega", 1), ("mega", 2), ("mega", 4), ("waves", None)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wave_kernels_match_plain_versions(cuda, case, schedule, seg_block):
    name, launch, plain, args = _wave_operands(schedule, *_on(CASES[case](), cuda), seg_block)
    before = build.launches[name]
    assigned, mb = launch(*args)
    assert build.launches[name] == before + 1
    want_a, want_mb = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(assigned, want_a)
    assert torch.equal(mb, want_mb)


@pytest.mark.parametrize("kw", [{}, {"schedule": "waves"}, {"schedule": "mega"}])
@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "rmat10_L64"])
def test_pipeline_on_card_matches_cpu(cuda, case, kw):
    c = CASES[case]()
    idx, weight = mwm_pipeline(*_on(c, cuda), part1="kernel", **kw)
    want_idx, want_weight = mwm_pipeline(*_on(c, "cpu"), part1="kernel", device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_weight


def test_kernel_refuses_what_it_cannot_take(cuda):
    edges = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    w = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_packed(edges, w, torch.ones((8, kernel.MAX_WIDTH + 8), device=cuda), 8)
    with pytest.raises(ValueError, match="weights on cpu"):
        kernel.substream_match_packed(edges, w.cpu(), torch.ones((8, 8), device=cuda), 8)
    offs = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="width"):
        kernel.substream_match_waves(torch.zeros((8, 2), dtype=torch.int32, device=cuda),
                                     torch.ones(8, device=cuda),
                                     torch.ones((8, 12), device=cuda), offs, 8, 8)
