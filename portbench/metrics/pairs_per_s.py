"""Stereo pairs whose results reached the host inside the window (streams
x steps), over the window's seconds (first call to last result)."""


def read(rec):
    return rec['streams'] * rec['steps'] / rec['window_s']
