"""The 95th percentile (nearest rank) of the frames' latencies (ms), over
every frame of the window."""
import math


def read(rec):
    ms = sorted(rec["item_ms"])
    return ms[max(math.ceil(0.95 * len(ms)) - 1, 0)]
