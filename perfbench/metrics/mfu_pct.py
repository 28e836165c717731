"""A training step's model FLOPs (6 per weight and token and three
times the causal attention products, no recompute) over the window's
time a step, against 989 TFLOP/s bf16."""
from yardstick import readers


def read(run):
    return readers.flops_share_pct(run, "step_flops")
