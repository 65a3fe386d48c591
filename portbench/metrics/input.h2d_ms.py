"""Device ms per step of the host-to-device copies (the frames through
``utils/devices.to_device`` and the graph's small inputs)."""
from portbench import tracelib


def read(rec):
    return tracelib.per_step_ms(
        rec['trace'], lambda e: e.cat == 'gpu_memcpy' and 'HtoD' in e.name)
