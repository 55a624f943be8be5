"""The program's own counters in a traced run, summed by timed item.

While the profiler records, the port's span module
(`ggrt_official_torch/utils/tracing.py`) keeps a record of each value it
counts, with its host time on the trace's clock; the values are grouped by
the `bench.item` range they fall in, as `program_spans.py` groups the
spans. A program without counters leaves none, and every reading here is
then empty.
"""
from __future__ import annotations

from benchmark import program_spans


def program_counts() -> list:
    """The port's counted values (none where it counts nothing)."""
    try:
        from ggrt_official_torch.utils import tracing
    except ImportError:
        return []
    counts = getattr(tracing, "counts", None)
    return counts() if counts is not None else []


def per_item(rec, name: str) -> list[float]:
    """Per item, the sum of the program's `name` counts in it."""
    tr = program_spans._traced(rec)
    if tr is None:
        return []
    recs = [c for c in program_counts() if c.name == name]
    return program_spans._per_item(tr, [c.at_ns for c in recs], [c.value for c in recs])
