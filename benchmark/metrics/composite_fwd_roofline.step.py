"""The compositor's fwd kernel against its roofline (%): the least time the
card could take for the live (pixel, Gaussian) pairs and records of the
window's first step, counted by the benchmark's reference, over the
kernel's time in that step from the trace. Stated against the H100's
data-sheet peaks (fp32 67 TFLOP/s, 3.35 TB/s); the run's power limit is in
its device line."""


def read(rec):
    w = rec["work"].get("composite_fwd")
    return None if not w else 100.0 * w["bound_ms"] / w["kernel_ms"]
