"""The encoder's device time in a request (ms): the median over the
window's requests of CUDA events around `PixelSplat.encode_pairs`
(backbone, epipolar transformer, depth predictor, Gaussian adapter)."""
import statistics


def read(rec):
    ms = rec["spans"].get("encoder")
    return statistics.median(ms) if ms else None
