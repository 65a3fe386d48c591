"""Host milliseconds of one call of ``track_raw`` and the start of its
result's fetch, without the wait for the result: the mean over the
window's steps (the untraced window of the traced run)."""
import numpy as np


def read(rec):
    return float(np.mean(rec['call_s'])) * 1e3
