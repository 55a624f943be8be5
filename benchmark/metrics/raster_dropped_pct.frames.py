"""The share of the binned (tile, Gaussian) pairs that the per-tile
capacity K (`max_per_tile`) cuts (%): the program's `raster.keys` counter
less its `raster.kept`, over `raster.keys`, summed over the traced window's
frames."""
from benchmark import program_counters


def read(rec):
    keys = sum(program_counters.per_item(rec, "raster.keys"))
    if not keys:
        return None
    return 100.0 * (keys - sum(program_counters.per_item(rec, "raster.kept"))) / keys
