"""The paper's own workload: substream-centric MWM configs (§5).

Default parameters follow the evaluation: K=32, L=64, eps=0.1, Kronecker
n = 2^16..2^21 (m ~= 48 n), weights U[1, (1+eps)^(L-1)+1].
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MatchingWorkload:
    name: str = "paper-matching"
    scale: int = 20  # Kronecker 2^scale vertices
    edge_factor: int = 48
    L: int = 64
    eps: float = 0.1
    K: int = 32  # blocking epoch rows
    seed: int = 0


CONFIG = MatchingWorkload()
SMOKE = dataclasses.replace(CONFIG, scale=8, edge_factor=8, L=16)
