"""95th percentile, over every step of the traced run's window, of the time
from the host's call of ``track_raw`` with a step's frames to that step's
``FrameResult`` on the host, in ms.  A per-layer metric: run to run it
swings with the host's stalls and the card's step time more than a bound
could hold."""
import numpy as np


def read(rec):
    return float(np.percentile(rec['latency_s'], 95)) * 1e3
