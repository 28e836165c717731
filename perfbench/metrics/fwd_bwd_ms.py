"""The card's busy time in a step outside AdamW and the EC copy: the
forward, the backward and the rematerialised forward, ms a step."""
from yardstick import readers


def read(run):
    return readers.busy_less(run, "optimizer", "ec_stage", "ec_commit")
