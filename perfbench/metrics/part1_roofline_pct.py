"""part1_roofline_pct: Part 1's least time over its device time, in %.
The least time is the bytes Part 1 must move (:func:`arith.part1_bytes`,
from each job's shapes) over the card's published memory bandwidth; the
device time is the busy time inside each job's ``substream_match`` span."""
import bisect

from perfbench import arith


def read(record):
    tr, peaks = record["trace"], record["peaks"]
    if not tr or not tr["device"] or not peaks:
        return None
    jobs = sorted((a, b) for name, a, b in tr["spans"] if name == "job")
    spans = [s for s in tr["spans"] if s[0] == "substream_match"]
    if not spans or len(jobs) != len(record["jobs"]):
        return None
    starts = [a for a, _ in jobs]
    busy = arith.Timeline((a, b) for _, a, b in tr["device"])
    least = spent = 0.0
    for _, a, b in spans:
        k = bisect.bisect_right(starts, a) - 1
        if k < 0 or b > jobs[k][1]:
            return None
        m = record["jobs"][k]["edges"]
        least += arith.part1_bytes(m, record["n"], record["L"]) / peaks["hbm_bytes_per_s"]
        spent += busy.busy(a, b)
    return None if spent <= 0 else 100.0 * least / spent
