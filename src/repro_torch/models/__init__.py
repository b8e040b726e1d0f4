"""The models of the port: the four GNNs (``gin``, ``egnn``,
``meshgraphnet``, ``equiformer_v2``) over ``gnn_common``, the LM family
(``transformer``: ``loss_fn``, prefill and decode) and BERT4Rec
(``bert4rec``: the cloze ``loss_fn`` and serving, over ``embedding``), all
over ``param``. Each module holds its config dataclass, ``param_specs`` and
an ``nn.Module`` whose parameters carry the JAX package's tree paths."""
