"""The CUDA kernel for Part 1 on packed bit planes, and its plain version.

:func:`substream_match_packed` replaces the TPU kernel ``_kernel_packed``
of the JAX package (``repro/kernels/substream_match/kernel.py:117``). On a
CUDA tensor it launches ``csrc/substream_match_packed.cu``; on a CPU tensor
it runs :func:`substream_match_packed_plain`, the same function in plain
PyTorch. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.substream_match import ref

NAME = "substream_match_packed"
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "substream_match_packed.cu"
#: widest row the kernel takes: 8 words per lane of one warp (L <= 2048)
MAX_WIDTH = 256


def _launcher():
    fn = build.load_library(NAME, SOURCE).substream_match_packed
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(edges, weights, thresholds, n_pad, mb_init):
    m = edges.shape[0]
    width = thresholds.shape[-1]
    expect = [
        ("edges", edges, torch.int32, (m, 2)),
        ("weights", weights, torch.float32, (m,)),
        ("thresholds", thresholds, torch.float32, (8, width)),
    ]
    if mb_init is not None:
        expect.append(("mb_init", mb_init, torch.uint8, (n_pad, width)))
    for name, t, dtype, shape in expect:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != edges.device:
            raise ValueError(f"{name} on {t.device}, edges on {edges.device}")
    if m:
        lo, hi = (int(x) for x in torch.aminmax(edges))
        if lo < 0 or hi >= n_pad:
            raise ValueError(f"vertex ids span [{lo}, {hi}], outside [0, {n_pad})")


def substream_match_packed_plain(edges, weights, thresholds, n_pad: int, mb_init=None):
    """Plain PyTorch version of the kernel on its own operand shapes; runs
    where its tensors lie. The bit-plane thresholds [8, width] flatten to
    the lane order 8k+j, and their +inf pads never match."""
    return ref.substream_match_ref_packed(
        edges[:, 0], edges[:, 1], weights, thresholds.T.reshape(-1), n_pad,
        mb0=mb_init,
    )


def substream_match_packed(
    edges: torch.Tensor,  # int32 [m, 2]
    weights: torch.Tensor,  # float32 [m]; 0 marks padding/invalid edges
    thresholds: torch.Tensor,  # float32 [8, width]; thr[j, k] = substream 8k+j, +inf pads
    n_pad: int,
    mb_init: torch.Tensor | None = None,  # uint8 [n_pad, width] carried-in bits
):
    """Part 1 over the edges in the order given.

    Returns (assigned int32 [m], mb uint8 [n_pad, width]). ``mb_init``
    seeds the bit block instead of zeros. Raises ``ValueError`` on an
    operand of the wrong type, shape or device, on a vertex id outside
    ``[0, n_pad)``, and on the card for ``width > MAX_WIDTH``.
    """
    _check(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type == "cpu":
        return substream_match_packed_plain(edges, weights, thresholds, n_pad, mb_init)
    if edges.device.type != "cuda":
        raise ValueError(f"no kernel for device {edges.device}")
    width = thresholds.shape[1]
    if width > MAX_WIDTH:
        raise ValueError(f"row width {width} words > {MAX_WIDTH} (L > {8 * MAX_WIDTH})")
    launch = _launcher()
    m = edges.shape[0]
    mb = (
        torch.zeros((n_pad, width), dtype=torch.uint8, device=edges.device)
        if mb_init is None
        else mb_init.clone()
    )
    assigned = torch.empty((m,), dtype=torch.int32, device=edges.device)
    with torch.cuda.device(edges.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            edges.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
            mb.data_ptr(), assigned.data_ptr(), m, width, stream,
        )
    if err:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err}")
    build.launches[NAME] += 1
    return assigned, mb
