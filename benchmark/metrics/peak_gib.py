"""The allocator's peak (GiB) over the window, reset at its start."""


def read(rec):
    return rec["peak_bytes"] / 2**30
