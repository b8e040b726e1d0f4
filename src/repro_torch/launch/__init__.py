"""Launch tooling of the port: the step builder (``steps``: the GNN, LM and
recsys train steps, the LM and recsys serving steps, the production
``arch_rules`` and ``build_step``), the meshes (``mesh``: host meshes, the
production meshes over a fake world), the roofline model (``roofline``: the
substream kernels' bound and the dry-run's terms at the H100's peaks), the
dry-run (``dryrun``, ``components``, ``report``: every arch x shape step
traced on ``meta`` DTensors of a fake 256- or 512-rank world), the sampled
GNN trainer (``gnn_train``), the LM trainer (``train_lm``), the BERT4Rec
server (``serve_recsys``) and the matching examples (``quickstart``,
``matching_e2e``)."""
