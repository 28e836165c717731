"""Kernel 11 (the bf16 flash-attention forward) against its bound at
the step's shape: operations at 989 TFLOP/s or bytes at 3.35 TB/s, per
launch."""
from yardstick import readers, work


def read(run):
    return readers.roofline_per_launch(run, readers.FLASH_CUDA, "flash_call",
                                       work.BF16_FLOPS_PER_S)
