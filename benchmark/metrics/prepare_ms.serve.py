"""A request's host preparation (ms): the median over the traced window's
requests of the host time inside the program's `ggrt.prepare_batch` span
(`training/trainer.py::prepare_batch`: the data shim, the pinned staging and
the host-to-device copies)."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.host_ms(rec, "prepare_batch")
    return statistics.median(ms) if ms else None
