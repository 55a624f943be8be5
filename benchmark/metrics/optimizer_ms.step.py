"""The optimizer's host time in a step (ms): the median over the traced
window's steps of the host time inside the program's `ggrt.optimizer` span
(`training/state.py::TrainState.apply_updates`: both optimizers' gating,
clipping and Adam steps)."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.host_ms(rec, "optimizer")
    return statistics.median(ms) if ms else None
