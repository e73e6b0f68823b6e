"""The share of the traced slice's wall-clock in which no kernel, copy or
memset ran on the card."""

UNIT = "%"


def read(m):
    return 100.0 * (1.0 - m.slice.busy_s() / m.slice.wall_s)
