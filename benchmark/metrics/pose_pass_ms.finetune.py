"""The deferred-BP step's pose pass (ms): the median over the window's steps
of CUDA events around `GGRtFinetuneTrainer.pose_pass`."""
import statistics


def read(rec):
    ms = rec["spans"].get("pose_pass")
    return statistics.median(ms) if ms else None
