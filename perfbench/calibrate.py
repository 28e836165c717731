#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size on
the card, many seeds in one process (``PERF.md`` lists them with the
limits).  The benchmark's runs never run this.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        [--faulted 1 2 3]

Training cells: for every seed the program's set-up and first steps (the
same ``setup`` a run makes) and their gaps from the fp32 reference (the
lower reading); for the ``--faulted`` seeds also the control, the
reference with fp8 products in the program's place, and the fault of
half the batch left out (the reference on the first half of each batch's
rows), each against the reference (the upper readings).  A state left
unchanged reads 1 on the parameter change and needs no run.

Failure cells: for every seed each position rebuilt by the program and
compared byte for byte (the lower reading), and for the ``--faulted``
seeds the control: the lost pages rebuilt as the XOR of their survivors,
as a code without GF(2^8) products would, from the program's parity.

One JSON line a seed.
"""
import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(Path(__file__).resolve().parent)]


def train_seed(cell, driver, seed: int, faulted: bool, dev) -> dict:
    from yardstick import card
    ctx = types.SimpleNamespace(cell=cell, seed=seed, seconds=0.0,
                                trace=False, device=dev)
    st = driver.setup(ctx)
    prog, specs = st["readings"], st["specs"]
    mix = cell.mix
    first = mix["first_steps"]
    batches = st["batches"][:first]
    driver.common.free_all(dev, st)
    out = {"seed": seed, "program_losses": prog["losses"]}
    ref = driver._reference(cell.config, specs, seed, dev, batches, first)
    out["sound"] = driver.gaps(prog, ref)
    if faulted:
        ctl = driver._reference(cell.config, specs, seed, dev, batches,
                                first, quant="fp8")
        out["control"] = driver.gaps(ctl, ref)
        half = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        hb = driver._reference(cell.config, specs, seed, dev, half, first)
        out["half_batch"] = driver.gaps(hb, ref)
    out["reference_losses"] = ref["losses"]
    card.log(json.dumps(out))
    return out


def recover_seed(cell, driver, seed: int, faulted: bool, dev) -> dict:
    from repro_torch.models.convert import param_tree
    from yardstick import card, gfref
    conf = cell.config
    cfg, model, named, specs = driver.common.build_model(conf, seed, dev)
    params = param_tree(model)
    ec, A, (k, m, page) = driver.common.ec_copy(conf, cfg, params)
    tensors = [(leaf.name, named[leaf.name]) for leaf in specs]
    pages = [gfref.position_pages(tensors, d, A, k, page) for d in range(A)]
    out = {"seed": seed, "sound": {"rebuilt_bytes_wrong": 0}}
    for f in range(A):
        rec = ec.reconstruct(params, f).select(0, 0).reshape(pages[f].shape)
        out["sound"]["rebuilt_bytes_wrong"] += int((rec != pages[f]).sum())
        del rec
    if faulted:
        wrong = 0
        for f in range(A):
            S = pages[f].shape[0] // k
            for j in range(k):
                l = (f - j) % A
                got = ec.parity[(l + k) % A, 0, 0].clone()
                for i in range(k):
                    if i != j:
                        got ^= pages[(l + i) % A].view(S, k, -1)[:, i]
                wrong += int((got != pages[f].view(S, k, -1)[:, j]).sum())
        out["control"] = {"rebuilt_bytes_wrong": wrong}
    del model, params, ec, named, tensors, pages
    card.free(dev)
    card.log(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faulted", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from yardstick import card, cells
    cell = cells.cell(ROOT, args.workload)
    why = card.missing(cell.chips)
    if why:
        print(f"calibrate: {why}", file=sys.stderr)
        return 2
    import torch
    dev = torch.device("cuda")
    driver = cells.driver(cell)
    each = train_seed if cell.mix["driver"] == "train" else recover_seed
    rows = [each(cell, driver, s, s in args.faulted, dev)
            for s in args.seeds + [s for s in args.faulted
                                   if s not in args.seeds]]
    print(json.dumps({"workload": args.workload, "card": card.power_limit(),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
