"""The binning's device time in a frame (ms): the median over the traced
window's frames of the program's `ggrt.raster.bin` span, timed by its CUDA
event pair (`ops/rasterizer/tiling.py::bin_gaussians`: the tile windows,
the sort of the duplicated (tile, depth) keys, the per-tile lists). The
pair also holds whatever idle time the host leaves inside the span."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.device_ms(rec, "raster.bin")
    return statistics.median(ms) if ms else None
