"""Reading a ``torch.profiler`` trace of the traced part of a window.

Copied in idea from the port's ``scripts/train_profile.py``: the device
is busy where any kernel, copy or set runs (the union of their intervals
on the device timeline), and a span - a ``record_function`` range the
harness opens around a call into one layer - is read as the union of the
device's intervals inside the range's annotation on the device timeline
(one stream, so the kernels the range launched).  Not the profiler's
``device_time_total`` of the range: it misses the kernels the port's
ctypes wrappers launch and can count a kernel twice.
"""
from __future__ import annotations

import dataclasses


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _gaps(intervals, lo: float, hi: float):
    """Idle (start, end) intervals of the device inside [lo, hi]."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def _annotation(ev) -> bool:
    """A range on the device timeline that is no device work: a
    ``record_function`` range or the profiler's own step ("ProfilerStep#n")."""
    return bool(getattr(ev, "is_user_annotation", False)) or \
        ev.name.startswith("ProfilerStep")


@dataclasses.dataclass
class Trace:
    """The device intervals (name, start µs, end µs), the span names'
    annotations on the device timeline, the host's events, and the traced
    window's host-clock length ``window_s`` with the count of iterations
    (steps, rebuilds) in it."""
    kernels: list
    annotations: dict
    host: list
    window_s: float
    iters: int

    @classmethod
    def from_profile(cls, prof, span_names, window_s: float, iters: int):
        from torch.autograd import DeviceType
        kernels, annotations, host = [], {n: [] for n in span_names}, []
        for ev in prof.events():
            s, e = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA:
                if ev.name in annotations:
                    annotations[ev.name].append((s, e))
                elif not _annotation(ev):
                    kernels.append((ev.name, s, e))
            elif ev.device_type == DeviceType.CPU and \
                    ev.name not in annotations:
                host.append((ev.name, s, e))
        return cls(kernels, annotations, host, window_s, iters)

    def busy_s(self) -> float:
        return union_us((s, e) for _, s, e in self.kernels) / 1e6

    def span_s(self, name: str) -> float | None:
        """Device-busy seconds inside the annotations of ``name``, or None
        when the trace holds none."""
        ranges = self.annotations.get(name) or []
        if not ranges:
            return None
        total = 0.0
        for lo, hi in ranges:
            total += union_us((s, e) for _, s, e in self.kernels
                              if s >= lo and e <= hi)
        return total / 1e6

    def kernel_s(self, cuda_name: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``cuda_name``."""
        hits = [e - s for n, s, e in self.kernels if cuda_name in n]
        return len(hits), sum(hits) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host event running at its
        middle."""
        by_name: dict = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        if not self.kernels:
            return {"device_ops": [], "idle_gaps": []}
        lo = min(s for _, s, _ in self.kernels)
        hi = max(e for _, _, e in self.kernels)
        gaps = sorted(_gaps([(s, e) for _, s, e in self.kernels], lo, hi),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            named.append([min(inside)[1] if inside else "none",
                          (b - a) / 1e6])
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": named}
