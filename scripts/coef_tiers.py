#!/usr/bin/env python3
"""Time kernels 5 and 6 at each size of their launch-parameter struct.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/coef_tiers.py

Kernels 4-7 take their coefficients by value in a parameter struct built
in three sizes (``kernels/coefs.py`` TIERS: 512, 4096 and 32,640 bytes);
the wrapper picks the smallest that holds a launch.  This script launches
the same call at every tier that holds it, through the library's C entry
points, at the main path's shapes (B = 64): kernel 6 with RS(10,8)'s two
parity rows at C 4096 (128 bytes of gammas), kernel 5 at the RS seal
(64, 1, 1) at C 4096 (64 bytes) and at the RDP seal (64, 16, 16) at C 256
as row masks (2,048 bytes).  Each output is checked against the plain
version.  Per tier it prints the CUDA-event time per launch over a run of
launches (``call_ms``: host launch cost included, the tiers in turns
small, large, large, small) and the kernel's device time per launch from
a ``torch.profiler`` trace (``kernel_ms``), after the card's name and
power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 2000


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("coef_tiers: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, coefs
    from repro_torch.kernels.delta_update import delta_apply_batched_plain
    from repro_torch.kernels.gf256_matmul import gf256_matmul_per_item_plain
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, cuda_ms, kernel_device_ms
    print(card_line(), flush=True)
    lib = _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    stream = _build.stream_ptr(dev)

    def u8(shape):
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    cases = {}
    # kernel 6: (64, 2) gammas, C 4096
    B, m, C = 64, 2, 4096
    g = rng.integers(0, 256, (B, m)).astype(np.uint8)
    P, X = u8((B, m, C)), u8((B, C))
    out6 = torch.empty((B, m, C), dtype=torch.uint8, device=dev)
    cases["delta_apply_m2_b64"] = dict(
        bytes=g.size, cuda_name="delta_batched_kernel", out=out6,
        want=delta_apply_batched_plain(P, g.astype(np.int32), X),
        launch=lambda tier, g=g, P=P, X=X, o=out6, B=B, m=m, C=C:
        lib.gf_delta_apply_batched(tier, g.ctypes.data, P.data_ptr(),
                                   X.data_ptr(), o.data_ptr(), B, m, C,
                                   stream))
    # kernel 5: RS seal (64, 1, 1) bytes at C 4096; RDP seal (64, 16, 16)
    # 0/1 as row masks at C 256
    for label, (O, J, C, zero_one) in {
            "fold_rs_b64": (1, 1, 4096, False),
            "fold_rdp_b64": (16, 16, 256, True)}.items():
        Ms = rng.integers(0, 2 if zero_one else 256, (B, O, J),
                          dtype=np.uint8)
        mb, host = coefs.per_item_coefs(Ms)
        D, Pf = u8((B, J, C)), u8((B, O, C))
        out = torch.empty((B, O, C), dtype=torch.uint8, device=dev)
        cases[label] = dict(
            bytes=host.size, cuda_name="per_item_kernel", out=out,
            want=gf256_matmul_per_item_plain(Ms, D, Pf),
            launch=lambda tier, h=host, mb=mb, D=D, Pf=Pf, o=out, O=O, J=J,
            C=C: lib.gf_per_item_fold(
                tier, h.ctypes.data, mb, Pf.data_ptr(), D.data_ptr(),
                o.data_ptr(), B, O, J, C, stream))

    for label, case in cases.items():
        tiers = [i for i, t in enumerate(coefs.TIERS) if case["bytes"] <= t]
        rows = {i: dict(tier_bytes=coefs.TIERS[i], call_ms=[]) for i in tiers}
        for i in tiers:
            case["out"].zero_()
            _build.check(case["launch"](i), label)
            torch.cuda.synchronize()
            assert torch.equal(case["out"], case["want"]), (label, i)
        for i in tiers + tiers[::-1]:
            rows[i]["call_ms"].append(cuda_ms(
                torch, lambda i=i: case["launch"](i), REPS))
        for i in tiers:
            rows[i]["kernel_ms"], _ = kernel_device_ms(
                torch, lambda i=i: case["launch"](i), 200, case["cuda_name"])
            print(json.dumps(dict(case=label, coef_bytes=case["bytes"],
                                  **rows[i])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
