"""Set-up (s): process start to the first timed item, builds and warm-up
included."""


def read(rec):
    return rec["setup_s"]
