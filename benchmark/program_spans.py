"""The program's own spans in a traced run, grouped by timed item.

While the profiler records, the port's span module
(`ggrt_official_torch/utils/tracing.py`) opens a `ggrt.<name>` range around
each layer it marks and keeps a record of it, with a CUDA event pair where
the span times the device. The ranges are host events of the trace, and the
records' host times are on the trace's clock, so both are grouped by the
`bench.item` range they start in. A program without the module leaves
neither, and every reading here is then empty.
"""
from __future__ import annotations

import numpy as np

PREFIX = "ggrt."


def program_records() -> list:
    """The port's finished span records (none where it has no span module)."""
    try:
        from ggrt_official_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans()


def _per_item(trace, starts, values) -> list[float]:
    """`values` summed by the timed item each start falls in; items with
    none are left out, and so are values outside every item."""
    lo = np.array([s for s, _ in trace.items], np.int64)
    hi = np.array([e for _, e in trace.items], np.int64)
    k = np.searchsorted(lo, np.asarray(starts, np.int64), side="right") - 1
    sums: dict[int, float] = {}
    for i, t, v in zip(k.tolist(), starts, values):
        if i >= 0 and t < hi[i]:
            sums[i] = sums.get(i, 0.0) + float(v)
    return [sums[i] for i in sorted(sums)]


def _ranges(trace, name: str):
    sel = trace.host_name == PREFIX + name
    return trace.host_s[sel], trace.host_e[sel]


def _traced(rec):
    tr = rec.get("trace")
    return tr if tr is not None and tr.items else None


def host_ms(rec, name: str) -> list[float]:
    """Per item, the host ms inside the `ggrt.<name>` ranges."""
    tr = _traced(rec)
    if tr is None:
        return []
    s, e = _ranges(tr, name)
    return _per_item(tr, s, (e - s) / 1e6)


def idle_ms(rec, name: str) -> list[float]:
    """Per item, the ms inside the `ggrt.<name>` ranges in which the device
    ran nothing: each range's length less the trace's busy time in it."""
    tr = _traced(rec)
    if tr is None:
        return []
    s, e = _ranges(tr, name)
    idle = [(b - a) / 1e6 - tr.busy_seconds(int(a), int(b)) * 1e3 for a, b in zip(s, e)]
    return _per_item(tr, s, idle)


def device_ms(rec, name: str) -> list[float]:
    """Per item, the device ms of the program's `name` spans (their CUDA
    event pairs), the records grouped by their host start."""
    tr = _traced(rec)
    if tr is None:
        return []
    recs = [r for r in program_records() if r.name == name and r.device_ms is not None]
    return _per_item(tr, [r.start_ns for r in recs], [r.device_ms for r in recs])
