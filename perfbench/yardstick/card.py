"""The card: whether the run may start, what it ran on, and waits.

A run needs ``torch.cuda.is_available()`` and as many cards as its cell
asks for; without them it prints no result.  Every number names its card
(``torch.cuda.get_device_name``) and the power limit ``nvidia-smi``
reads, since a card set below 700 W runs slower under load.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of progress on standard error, with seconds since import."""
    print(f"[perfbench {time.perf_counter() - _T0:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def missing(chips: int) -> str | None:
    """Why a run cannot start on this host, or None."""
    if not torch.cuda.is_available():
        return "no CUDA card (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA cards, the cell asks "
                f"for {chips}")
    return None


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def describe(dev: torch.device, chips: int) -> dict:
    """The result's ``device`` entry (its memory peak is added later)."""
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Stopwatch:
    """Per-iteration latency of work that ends in a wait: CUDA events on
    the card's stream (the device's clock, exact to microseconds; the
    start event fires at once because the card is idle when it is
    recorded), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self) -> float:
        """Wait for the work and return its milliseconds."""
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return float(self.a.elapsed_time(self.b))
        return (time.perf_counter() - self.t) * 1e3
