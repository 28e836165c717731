"""Kernel 1 (the GF(2^8) shared-matrix product) against its bytes bound
over an iteration: in a training step's EC update the update's pages
read once and its products written once, in a rebuild the survivors of
each lost page read once and the page written once."""
from yardstick import readers


def read(run):
    return readers.roofline_per_iter(run, readers.KERNEL1_CUDA,
                                     "kernel1_per_iter")
