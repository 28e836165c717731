"""The numbers that decide ``correct``, each against its limit.

A cell's limits file (``limits/<workload>.json``) gives every compared
number its limit; ``PERF.md`` gives the readings each was set from.  A
number over its limit, or one that could not be read (None), makes the
run not correct.  ``report`` prints each number beside its limit on
standard error, the last lines a run prints there.
"""
from __future__ import annotations

import json
import statistics
import sys

#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone under Adam; the parameter change
#: leaves them out
NOUGHT = 1e-3


def leaf_gap(prog: dict, ref: dict, names=None):
    """(the worst leaf's gap, its name): |prog - ref| over the larger of
    the reference's value of that leaf and the median leaf's."""
    names = sorted(ref) if names is None else sorted(names)
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if at is None or gap > worst:
            worst, at = gap, n
    return worst, at


def moving(ref_grads: dict) -> list:
    """The leaves whose reference gradient is at least ``NOUGHT`` of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= NOUGHT * med]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, out


def report(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=stream)
    print("checks " + json.dumps(checks), file=stream, flush=True)
