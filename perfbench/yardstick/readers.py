"""The reductions the per-layer metric files (``metrics/<name>.py``) make
of a traced run.

``run`` carries ``trace`` (``trace.Trace`` of the iterations the driver
ran under the profiler after the window, or None), ``window``
((iterations, seconds) of the window, which runs before anything is
profiled, as in an untraced run) and ``work`` (the driver's operations
and bytes per iteration and per call, from the configuration's shapes).
The profiler slows the host, so a share of time is taken as the card's
busy time an iteration in the trace over the window's time an
iteration.  Every reader returns
None where its run holds nothing to read, and the metric is then left
out of the result; a share of a roofline or a peak is never 0 for lack
of a reading.
"""
from __future__ import annotations

from . import work

FLASH_CUDA = "flash_attention_wgmma_kernel"
KERNEL1_CUDA = "matmul_batched_kernel"


def span_ms(run, *names) -> float | None:
    """Milliseconds an iteration of the card's busy time inside the spans
    ``names`` (summed)."""
    t = run.trace
    if t is None or not t.iters:
        return None
    parts = [t.span_s(n) for n in names]
    if any(p is None for p in parts):
        return None
    return sum(parts) / t.iters * 1e3


def busy_less(run, *parts) -> float | None:
    """Milliseconds an iteration of the card's busy time outside the
    spans ``parts``."""
    t = run.trace
    p = span_ms(run, *parts)
    if p is None or t.busy_s() <= 0:
        return None
    return t.busy_s() / t.iters * 1e3 - p


def _iter_s(run) -> float | None:
    """The untraced window's seconds an iteration."""
    n, secs = run.window or (0, 0.0)
    return secs / n if n > 0 and secs > 0 else None


def idle_pct(run) -> float | None:
    """The share of an untraced iteration in which the card runs
    nothing: 1 - its busy time an iteration in the trace over the
    window's time an iteration."""
    t, it = run.trace, _iter_s(run)
    if t is None or not t.iters or it is None or t.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.iters / it)


def flops_share_pct(run, key: str) -> float | None:
    """The whole iteration's model FLOPs (``work[key]`` each) over the
    window's time an iteration, against the bf16 peak."""
    it = _iter_s(run)
    if it is None or key not in run.work:
        return None
    return 100.0 * run.work[key] / it / work.BF16_FLOPS_PER_S


def bytes_share_pct(run, key: str) -> float | None:
    """The whole iteration's necessary bytes (``work[key]`` each) over
    the window's time an iteration, against the HBM peak."""
    it = _iter_s(run)
    if it is None or key not in run.work:
        return None
    return 100.0 * run.work[key] / it / work.HBM_BYTES_PER_S


def roofline_per_launch(run, cuda_name: str, key: str,
                        ops_per_s: float) -> float | None:
    """A kernel's share of its roofline: launches in the trace times the
    least time one call at the shape ``work[key]`` (bytes, operations)
    could take, over the kernels' device time."""
    t = run.trace
    if t is None or key not in run.work:
        return None
    launches, secs = t.kernel_s(cuda_name)
    if not launches or secs <= 0:
        return None
    least, _ = work.bound(*run.work[key], ops_per_s=ops_per_s)
    return 100.0 * launches * least / secs


def roofline_per_iter(run, cuda_name: str, key: str) -> float | None:
    """A kernel's share of its roofline over the traced iterations: the
    least time the iteration's work for it (``work[key]``: bytes and
    byte operations, each input read once and each output written once)
    could take, times the iterations, over the kernel's device time."""
    t = run.trace
    if t is None or not t.iters or key not in run.work:
        return None
    launches, secs = t.kernel_s(cuda_name)
    if not launches or secs <= 0:
        return None
    least, _ = work.bound(*run.work[key])
    return 100.0 * t.iters * least / secs
