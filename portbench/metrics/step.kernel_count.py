"""Device kernels per step in the traced stretch."""


def read(rec):
    tr = rec['trace']
    if tr is None:
        return None
    n = sum(1 for e in tr.device if e.cat == 'kernel')
    return n / tr.steps if n else None
