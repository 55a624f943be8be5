"""The deferred-BP step's crop-tile pass (ms): the median over the window's
steps of CUDA events around `GGRtFinetuneTrainer.tile_pass`."""
import statistics


def read(rec):
    ms = rec["spans"].get("tile_pass")
    return statistics.median(ms) if ms else None
