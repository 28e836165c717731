"""The card's busy time inside the EC copy's stage and commit
(pack, XOR, rotate, kernel 1, fold), ms a step."""
from yardstick import readers


def read(run):
    return readers.span_ms(run, "ec_stage", "ec_commit")
