"""The models of the port: the four GNNs (``gin``, ``egnn``,
``meshgraphnet``, ``equiformer_v2``) over ``gnn_common``, the LM family
(``transformer``: prefill and decode) and BERT4Rec (``bert4rec``: serving,
over ``embedding``), all over ``param``. Each module holds its config
dataclass, ``param_specs`` and an ``nn.Module`` whose parameters carry the
JAX package's tree paths. The LM and BERT4Rec losses belong to the training
path, not ported yet (ROADMAP.md §1 item 14)."""
