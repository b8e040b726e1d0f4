"""Launch tooling of the port: the substream kernels' roofline model, the
step builder (``steps``: the GNN, LM and recsys train steps and the LM and
recsys serving steps), host meshes (``mesh``), the sampled GNN trainer
(``gnn_train``), the LM trainer (``train_lm``), the BERT4Rec server
(``serve_recsys``) and the matching examples (``quickstart``,
``matching_e2e``). The dry-run tooling of the JAX package's
``repro.launch`` (components, dryrun, report, ``make_production_mesh``,
the HLO half of roofline) is not ported yet (ROADMAP.md §1 item 14)."""
