"""Seconds from the start of the process to the first step of the window:
imports, the kernel library's build or load, weights, frames, warm-up and
the step's capture."""


def read(rec):
    return rec['setup_s']
