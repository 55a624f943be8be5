"""The port's spans: named ranges at its layer boundaries, on only while a
`torch.profiler` session records.

    with span("raster.bin"):                 # a context manager
        ...

    @span("iponet", device=True)             # or a decorator
    def iponet(...): ...

There is no switch of its own: a span is on exactly while the profiler is
(`prof.start()` to `prof.stop()`, or a `with torch.profiler.profile()`
block). Off, it costs an attribute read and two dict lookups, and returns a
shared null context. On, it opens `record_function("ggrt.<name>")`, so the
trace holds the range on the same clock as the device's kernels, and keeps a
`Span` record: its parent, the id of its outermost span, its host start and
end in ns on the profiler's event clock (`time.time_ns()`, Unix-epoch ns, as
the trace's host events), and with `device=True`, when CUDA is initialised
and the current stream is not capturing, a CUDA event pair on that stream.
`spans()` returns the finished records, their device ms resolved after one
`synchronize()`; `clear()` drops them.

A decorator's wrapper holds the call's arguments until it returns: where a
function frees a caller's temporary by rebinding a parameter, put the span
in its body instead.

Counters go with the spans: `count("raster.keys", n)` adds a `Count` record
while the profiler records, and nothing otherwise. `n` is a host number or
a tensor whose elements sum to the count: a tensor is kept as it is, on
its device and unread, and `counts()` reads it, so counting adds no host
wait and no launch where it counts. The caller leaves a counted tensor
unmodified.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_records: list = []
_counts: list = []
_ids = itertools.count()
_local = threading.local()


class Span:
    """One finished span. `parent` and `root` are span ids (`root` is the id
    of the outermost span around it, its own if none); times are ns on the
    profiler's clock; `device_ms` is None without an event pair."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "children_ns", "device_ms",
                 "_events")

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """Host ms less the host ms of its child spans."""
        return (self.end_ns - self.start_ns - self.children_ns) / 1e6


class Count:
    """One counted value: `name`, its host time in ns on the profiler's
    clock (`at_ns`) and `value` (a tensor until `counts()` reads it)."""

    __slots__ = ("name", "at_ns", "value")


class _Site:
    __slots__ = ("name", "device")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)
        return spanned


class _Off(_Site):
    """The shared null span of one site while nothing profiles."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _On(_Site):
    __slots__ = ("rec", "range")

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        rec = self.rec = Span()
        rec.name, rec.id, rec.children_ns, rec.device_ms, rec._events = self.name, next(_ids), 0, None, None
        rec.parent = stack[-1].id if stack else None
        rec.root = stack[0].id if stack else rec.id
        stack.append(rec)
        self.range = torch.profiler.record_function(f"ggrt.{self.name}")
        self.range.__enter__()
        # The host start before the event pair is made: making and recording
        # it takes ~50-130 us under the profiler (an H100's host).
        rec.start_ns = time.time_ns()
        if self.device and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            rec._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec._events[0].record()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if rec._events is not None:
            rec._events[1].record()
        self.range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children_ns += rec.end_ns - rec.start_ns
        _records.append(rec)
        return False


_OFF = {False: {}, True: {}}


def span(name: str, device: bool = False):
    """A span named `ggrt.<name>`, as a context manager or a decorator;
    `device=True` also times the block on the current CUDA stream."""
    if not _profiler._is_profiler_enabled:
        site = _OFF[device].get(name)
        if site is None:
            site = _OFF[device][name] = _Off(name, device)
        return site
    return _On(name, device)


def count(name: str, value) -> None:
    """Count `value` (a number, or a tensor on any device whose elements sum
    to the count, kept unread) under `name`, while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    rec = Count()
    rec.name, rec.value, rec.at_ns = name, value, time.time_ns()
    _counts.append(rec)


def counts() -> list[Count]:
    """The counted values, oldest first, each a Python number: a tensor's
    elements summed on the host (they stay recorded)."""
    for r in _counts:
        if isinstance(r.value, torch.Tensor):
            r.value = r.value.cpu().sum().item()
    return list(_counts)


def spans() -> list[Span]:
    """The finished spans, oldest end first (they stay recorded)."""
    pending = [r for r in _records if r._events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms, r._events = r._events[0].elapsed_time(r._events[1]), None
    return list(_records)


def clear() -> None:
    _records.clear()
    _counts.clear()
