"""The models of the port: the four GNNs (``gin``, ``egnn``,
``meshgraphnet``, ``equiformer_v2``) over ``gnn_common`` and ``param``.
Each module holds its config dataclass, ``param_specs`` and an
``nn.Module`` (``MODEL``) whose parameters carry the JAX package's tree
paths. The transformer, bert4rec and embedding modules are not ported yet
(ROADMAP.md §1 item 14)."""
