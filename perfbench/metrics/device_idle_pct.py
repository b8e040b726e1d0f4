"""device_idle_pct: share of the traced window in which no kernel, copy
or memset ran on the card."""
from perfbench import arith


def read(record):
    tr = record["trace"]
    if not tr or not tr["device"]:
        return None
    win = [s for s in tr["spans"] if s[0] == "window"]
    if not win:
        return None
    _, lo, hi = win[0]
    busy = arith.covered([(a, b) for _, a, b in tr["device"]], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
