"""Seconds from the process start to the window: imports, CUDA start, the
stream, the warm-up (the first run in a checkout also builds the
kernel libraries)."""


def read(rec):
    return rec["setup_s"]
