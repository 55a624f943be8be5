"""The cached trainer's encodes in a step (ms): the median over the traced
window's steps of the program's `ggrt.cache.encode` span, timed by its CUDA
event pair (the encoder on each pair the cache misses, forward only; their
backward runs in the step's one backward)."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.device_ms(rec, "cache.encode")
    return statistics.median(ms) if ms else None
