"""The duplicated keys a frame's binning sorts ahead of its padding, in
millions: the median over the traced window's frames of the program's
`raster.keys` counter (the (tile, Gaussian) pairs whose tile lies in the
image; the sort also moves the Gaussians x max_dup - keys padding
entries)."""
import statistics

from benchmark import program_counters


def read(rec):
    keys = program_counters.per_item(rec, "raster.keys")
    return statistics.median(keys) / 1e6 if keys else None
