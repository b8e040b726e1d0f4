"""PyTorch/CUDA port of the substream-centric maximum weighted matching.

The package mirrors the JAX package ``repro`` module for module, so each
counterpart is easy to find, and imports neither JAX nor ``repro``.
Entry points take ``device=None``, which means the CUDA card; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.

Public call::

    from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline

    stream = EdgeStream.from_numpy(src, dst, weights)
    cfg = SubstreamConfig(n=num_vertices, L=64, eps=0.1)
    edge_indices, weight = mwm_pipeline(stream, cfg, part1="kernel")
"""
