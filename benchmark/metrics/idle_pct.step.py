"""The device's idle share of the traced window (%): 100 x (1 - busy/window),
busy the time in which a kernel, copy or set ran."""


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr.items:
        return None
    return 100.0 * (1.0 - tr.busy_seconds() / tr.window_s())
