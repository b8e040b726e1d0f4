"""part2_ms: per job, the ``mwm_pipeline`` span less its ``mwm_blocked``
span: Part 2's merge and the weight, wherever they run."""
from perfbench import arith


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    t = arith.self_time(tr["spans"], "mwm_pipeline", "mwm_blocked")
    return None if t is None else t * 1e3
