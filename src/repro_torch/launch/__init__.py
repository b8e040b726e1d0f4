"""Launch tooling of the port: the substream kernels' roofline model, the
GNN half of the step builder (``steps``) and the sampled GNN trainer
(``gnn_train``). The dry-run tooling of the JAX package's
``repro.launch`` (components, dryrun, mesh, report, the HLO half of
roofline) and the LM and recsys steps are not ported yet (ROADMAP.md §1
item 14)."""
