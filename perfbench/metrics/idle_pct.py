"""The share of an iteration in which no kernel, copy or set runs on the
card: the trace's busy time an iteration over the window's time an
iteration."""
from yardstick import readers


def read(run):
    return readers.idle_pct(run)
