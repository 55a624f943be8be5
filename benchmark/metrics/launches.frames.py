"""Kernel launches per frame in the traced window (copies and sets not
counted): the median over frames, which repeats exactly."""
import statistics


def read(rec):
    tr = rec["trace"]
    return float(statistics.median(tr.launches_per_item())) if tr is not None and tr.items else None
