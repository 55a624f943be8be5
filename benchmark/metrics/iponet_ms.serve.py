"""IPO-Net's device time in a request (ms): the median over the window's
requests of CUDA events around `GGRtModel.iponet`."""
import statistics


def read(rec):
    ms = rec["spans"].get("iponet")
    return statistics.median(ms) if ms else None
