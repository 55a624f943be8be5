"""The photometric SfM loss's device time in a step (ms): the median over
the traced window's steps of the program's `ggrt.sfm_loss` span, timed by
its CUDA event pair (the forward `photometric_decay_loss` call in
`GGRtModel.iponet`)."""
import statistics

from benchmark import program_spans


def read(rec):
    ms = program_spans.device_ms(rec, "sfm_loss")
    return statistics.median(ms) if ms else None
