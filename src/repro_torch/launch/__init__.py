"""Launch tooling of the port: the substream kernels' roofline model, the
step builder (``steps``: the GNN, LM and recsys train steps and the LM and
recsys serving steps), the sampled GNN trainer (``gnn_train``), the LM
trainer (``train_lm``) and the BERT4Rec server (``serve_recsys``). The
dry-run tooling of the JAX package's ``repro.launch`` (components, dryrun,
mesh, report, the HLO half of roofline) is not ported yet (ROADMAP.md §1
item 14)."""
