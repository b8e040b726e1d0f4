"""Card-only tests of the port: the CUDA kernel against its plain version,
and the main path on the card against the same path on the CPU. They skip
without a CUDA device; on a machine with an NVIDIA card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import kernel_inputs
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


@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "rmat10_L64"])
def test_pipeline_on_card_matches_cpu(cuda, case):
    c = CASES[case]()
    idx, weight = mwm_pipeline(*_on(c, cuda), part1="kernel")
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
