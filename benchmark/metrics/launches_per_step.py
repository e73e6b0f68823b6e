"""Device kernel launches in the traced slice, over its steps: the loops'
and dispatch's cost (training/coaches.py, training/projectors.py,
editing/zssgan.py)."""

UNIT = "launches"


def read(m):
    return m.slice.launches() / m.slice.steps
