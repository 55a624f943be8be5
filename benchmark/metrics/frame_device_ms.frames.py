"""A frame's device time (ms): the median over the traced window's frames of
the time in which the device ran something inside the frame's range."""
import statistics


def read(rec):
    tr = rec["trace"]
    return statistics.median(tr.item_busy_ms()) if tr is not None and tr.items else None
