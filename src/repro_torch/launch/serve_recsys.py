"""Serve BERT4Rec: batched request scoring against the full item table,
and retrieval against a candidate set, with the two-stage sharded top-k.
The counterpart of the JAX package's ``examples/serve_recsys.py``, with its
defaults (the smoke config, batches of 32, top 10 over 4 shards):

    PYTHONPATH=src python -m repro_torch.launch.serve_recsys

``--device cpu`` runs on the CPU; by default it runs on the CUDA card and
raises without one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.types import resolve_device
from repro_torch.data import RecsysPipeline
from repro_torch.launch.steps import sharded_topk
from repro_torch.models.bert4rec import Bert4Rec, score_candidates, serve_scores

#: the example's requests a batch and timed batches
BATCH, BATCHES = 32, 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch("bert4rec").smoke_config
    model = Bert4Rec(cfg, device=dev, seed=0)
    pipe = RecsysPipeline(cfg.item_vocab, BATCH, cfg.seq_len, cfg.n_mask,
                          cfg.n_negatives, cfg.n_context, seed=1, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def serve(b):
        return sharded_topk(serve_scores(model, b["item_ids"], b["context_ids"]), k=10, shards=4)

    batch = pipe.batch_at(0)
    serve(batch)
    sync()
    t0 = time.perf_counter()
    for s in range(BATCHES):
        vals, idxs = serve(pipe.batch_at(s))
        sync()
    dt = (time.perf_counter() - t0) / BATCHES
    print(f"batched serving: {BATCH / dt:.0f} req/s (batch {BATCH}, "
          f"vocab {cfg.item_vocab}) on {dev}")
    print("top-5 items for request 0:", idxs[0, :5].tolist(),
          "scores:", np.round(vals[0, :5].cpu().numpy(), 3))
    cands = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.item_vocab, 256).astype(np.int32)).to(dev)
    sc = score_candidates(model, batch["item_ids"][:1], batch["context_ids"][:1], cands)
    print(f"retrieval scoring vs {len(cands)} candidates:", tuple(sc.shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
