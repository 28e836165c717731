"""The card's busy time inside AdamW's apply, ms a step."""
from yardstick import readers


def read(run):
    return readers.span_ms(run, "optimizer")
