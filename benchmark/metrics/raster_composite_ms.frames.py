"""The compositor's device time in a frame (ms): the median over the traced
window's frames of the program's `ggrt.raster.composite` span, timed by its
CUDA event pair (`cuda_composite.CompositeCore`: the forward compositor
kernel over every tile)."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.device_ms(rec, "raster.composite")
    return statistics.median(ms) if ms else None
