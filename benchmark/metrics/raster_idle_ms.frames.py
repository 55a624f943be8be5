"""The device's idle time inside a frame's rasterizer call (ms): the median
over the traced window's frames of the time inside the program's
`ggrt.raster` span (`ops/rasterizer/api.py::render`) in which the device ran
no kernel, copy or set."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.idle_ms(rec, "raster")
    return statistics.median(ms) if ms else None
