"""Launch tooling of the port: the substream kernels' roofline model (the
rest of the JAX package's ``repro.launch`` is not ported yet, ROADMAP.md
§1 item 14)."""
