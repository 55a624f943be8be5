"""Step time (ms): the whole window over the optimizer steps completed in it."""


def read(rec):
    return rec["window_s"] * 1e3 / rec["items"]
