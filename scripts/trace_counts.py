#!/usr/bin/env python3
"""Does a ``torch.profiler`` trace hold every kernel launch?  In a fresh
process on the card, calls three wrappers (kernel 6 at (1, 2) x (1,
4096), kernel 1 at (8, 8) x (1, 8, 512) and at (1, 2) x (2e6, 2, 256))
3 and 50 times under the profiler, twice each, and prints one JSON line
per trace: the launches the wrappers counted, the matching kernels the
trace held, how many of those start at distinct times, duplicated event
ids, the trace's most common device event names and the first eight
kernels' microseconds.

    PYTHONPATH=src python3 scripts/trace_counts.py

Needs a card.  ``chip_smoke.kernel_device_ms`` scales the trace's mean by
the counted launches because traces late in that script's run held fewer
kernels than were launched.
"""
import collections
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("trace_counts: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, launch_counts
    _build.library()
    gm = importlib.import_module("repro_torch.kernels.gf256_matmul")
    du = importlib.import_module("repro_torch.kernels.delta_update")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def u8(*s):
        return torch.randint(0, 256, s, dtype=torch.uint8, device=dev,
                             generator=g)

    delta = (u8(1, 2, 4096), np.array([[3, 7]], np.uint8), u8(1, 4096))
    small = (np.random.default_rng(0).integers(0, 256, (8, 8))
             .astype(np.uint8), u8(1, 8, 512))
    large = (np.array([[1, 2]], np.uint8), u8(2000000, 2, 256))
    cases = {
        "delta (1,2)x(1,4096)": ("delta_batched_kernel",
                                 lambda: du.delta_apply_batched(*delta)),
        "matmul (8,8)x(1,8,512)": ("matmul_batched_kernel",
                                   lambda: gm.gf256_matmul_batched(*small)),
        "matmul (1,2)x(2e6,2,256)": ("matmul_batched_kernel",
                                     lambda: gm.gf256_matmul_batched(*large)),
    }
    for label, (cname, fn) in cases.items():
        for reps in (3, 50):
            for trial in range(2):
                fn()
                torch.cuda.synchronize()
                before = sum(launch_counts().values())
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                launched = sum(launch_counts().values()) - before
                evs = [ev for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA]
                match = [ev for ev in evs if cname in ev.name]
                names = collections.Counter(ev.name[:60] for ev in evs)
                ids = collections.Counter((ev.id, ev.time_range.start)
                                          for ev in match)
                print(json.dumps(dict(
                    case=label, reps=reps, trial=trial, launched=launched,
                    matched=len(match),
                    distinct_start=len({ev.time_range.start
                                        for ev in match}),
                    dup_ids=sum(1 for v in ids.values() if v > 1),
                    names=dict(names.most_common(6)),
                    us=[round(ev.time_range.elapsed_us(), 3)
                        for ev in match[:8]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
