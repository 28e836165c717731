"""The whole iteration's share of the chip's peak where the iteration
moves bytes and computes no FLOPs, as a rebuild does: its necessary
bytes (the survivors of each lost page read once, the page written once)
over the window's time an iteration, against 3.35 TB/s."""
from yardstick import readers


def read(run):
    return readers.bytes_share_pct(run, "iter_bytes")
