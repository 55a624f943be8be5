"""What a `torch.profiler` trace of the measured window says: the device's
busy time, its idle gaps and what the host did in them, kernel time by
name, and the same for each timed item.

The loop marks each timed item with `record_function("bench.item")` and
each span it wants with `record_function("bench.<span>")`; those ranges
are host-side events of the trace. Device events are kernels, copies and
sets (the trace's CUDA events other than annotations).
"""
from __future__ import annotations

import numpy as np

ITEM = "bench.item"


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Disjoint, sorted intervals covering the given ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def _covered(us: np.ndarray, ue: np.ndarray, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the disjoint intervals (us, ue) cover."""
    return int(np.clip(np.minimum(ue, hi) - np.maximum(us, lo), 0, None).sum())


class Trace:
    """The reduced trace of one measured window."""

    def __init__(self, prof):
        dev_name, dev_s, dev_e, host_name, host_s, host_e = [], [], [], [], [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = _ns(e, "start")
            end = start + max(_ns(e, "duration"), 0)
            if "CUDA" in str(e.device_type()):
                if name.startswith("bench.") or e.is_user_annotation():
                    continue
                dev_name.append(name), dev_s.append(start), dev_e.append(end)
            else:
                host_name.append(name), host_s.append(start), host_e.append(end)
        self.dev_name = np.array(dev_name, dtype=object)
        self.dev_s, self.dev_e = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
        self.host_name = np.array(host_name, dtype=object)
        self.host_s, self.host_e = np.array(host_s, np.int64), np.array(host_e, np.int64)
        items = np.flatnonzero(self.host_name == ITEM)
        order = np.argsort(self.host_s[items])
        self.items = [(int(self.host_s[i]), int(self.host_e[i])) for i in items[order]]
        self.busy_s, self.busy_e = _union(self.dev_s, self.dev_e)
        self.is_kernel = np.array([not n.startswith(("Memcpy", "Memset")) for n in dev_name], bool)

    @property
    def window(self) -> tuple[int, int]:
        """[first item's start, last item's end) in the trace's ns."""
        return self.items[0][0], self.items[-1][1]

    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def busy_seconds(self, lo: int | None = None, hi: int | None = None) -> float:
        """Seconds of [lo, hi) (default: the window) in which the device ran
        something."""
        if lo is None:
            lo, hi = self.window
        return _covered(self.busy_s, self.busy_e, lo, hi) / 1e9

    def item_busy_ms(self) -> list[float]:
        return [self.busy_seconds(lo, hi) * 1e3 for lo, hi in self.items]

    def kernels_in(self, lo: int, hi: int, contains: str | None = None) -> np.ndarray:
        """Indices of the device kernels (no copies or sets) that start in
        [lo, hi), optionally those whose name contains `contains`."""
        sel = self.is_kernel & (self.dev_s >= lo) & (self.dev_s < hi)
        if contains is not None:
            sel &= np.array([contains in n for n in self.dev_name], bool).reshape(sel.shape)
        return np.flatnonzero(sel)

    def kernel_ms(self, lo: int, hi: int, contains: str) -> tuple[float, int]:
        """(ms, launches) of the kernels named with `contains` in [lo, hi)."""
        idx = self.kernels_in(lo, hi, contains)
        return float((self.dev_e[idx] - self.dev_s[idx]).sum()) / 1e6, int(idx.size)

    def launches_per_item(self) -> list[int]:
        return [int(self.kernels_in(lo, hi).size) for lo, hi in self.items]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and the
        longest idle gaps, each named by what the host was doing: the
        innermost benchmark span and the innermost host operation around the
        gap's start."""
        lo, hi = self.window
        inside = (self.dev_s >= lo) & (self.dev_s < hi)
        totals: dict[str, float] = {}
        for n, s, e in zip(self.dev_name[inside], self.dev_s[inside], self.dev_e[inside]):
            totals[n] = totals.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        s, e = self.busy_s, self.busy_e
        gap_s = np.concatenate([[lo], e])
        gap_e = np.concatenate([s, [hi]])
        gap_s, gap_e = np.clip(gap_s, lo, hi), np.clip(gap_e, lo, hi)
        length = gap_e - gap_s
        gaps = []
        for i in np.argsort(-length)[:top]:
            if length[i] <= 0:
                break
            gaps.append([self.host_activity(int(gap_s[i])), float(length[i]) / 1e9])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": gaps}

    def host_activity(self, t: int) -> str:
        around = (self.host_s <= t) & (self.host_e > t)
        idx = np.flatnonzero(around)
        if idx.size == 0:
            return "host idle"
        names = self.host_name[idx]
        lengths = self.host_e[idx] - self.host_s[idx]
        bench = [i for i in range(idx.size) if names[i].startswith("bench.") and names[i] != ITEM]
        span = names[min(bench, key=lambda i: lengths[i])] if bench else ITEM
        op = [i for i in range(idx.size) if not names[i].startswith("bench.")]
        inner = names[min(op, key=lambda i: lengths[i])] if op else "python"
        return f"{span} / {inner}"
