"""The plain reference against the port on the CPU at test sizes: the
trained model (both layer kinds) and the rebuilt pages agree with the
program's, the GF(2^8) reference and the weights' draw hold their own
statements, and the control (the reference in fp8) reads further from
the reference than the bf16 program does."""
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from yardstick import (cells, gfref, harness, refmodel, tiny,  # noqa: E402
                       traffic, weights)

CPU = torch.device("cpu")


def _run(root, workload, seed=5, trace=False):
    return harness.run_workload(root, workload, seed, 0.2, trace, CPU,
                                time.perf_counter())


@pytest.mark.parametrize("workload", ["tiny-a.train", "tiny-l.train"])
def test_reference_trains_as_the_port_does(tmp_path, workload):
    """fp32 at test size: the program's losses, first gradients and
    parameter changes equal the reference's to rounding, and its parity
    is the reference's encode byte for byte."""
    line = _run(tiny.root(tmp_path), workload)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert line["correct"], checks
    assert checks["parity_bytes_wrong"] == 0
    r = line["readings"]
    for a, b in zip(r["program"]["losses"], r["reference"]["losses"]):
        assert abs(a - b) / abs(b) < 1e-5
    assert checks["grad_leaf_gap"] < 1e-4
    assert checks["change_leaf_gap"] < 1e-4
    assert line["attempted"] >= 1


def test_reference_pages_are_the_rebuilt_pages(tmp_path):
    line = _run(tiny.root(tmp_path), "tiny-a.recover", trace=True)
    assert line["correct"], line["checks"]
    assert line["readings"]["rebuilds_compared"] >= 2


def test_gf_reference():
    assert gfref.cauchy_parity(3, 2) == [[142, 244]]
    x = torch.arange(256, dtype=torch.uint8)
    for c in (0, 1, 2, 3, 29, 142, 244, 255):
        got = gfref.mul_const(x, c).tolist()
        assert got == [gfref.gf_mul(a, c) for a in range(256)]
    for a in range(1, 256, 17):
        assert gfref.gf_mul(a, gfref.gf_inv(a)) == 1
    g = torch.Generator().manual_seed(0)
    A, k, S = 4, 2, 5
    pages = [torch.randint(0, 256, (S * k, 8), generator=g,
                           dtype=torch.uint8) for _ in range(A)]
    gamma = gfref.cauchy_parity(3, 2)
    for d in range(A):
        row = gfref.parity_row(pages, d, 0, k, gamma, chunk=2)
        l = (d - k) % A
        for s in range(S):
            for b in range(8):
                want = gfref.gf_mul(int(pages[l][s * k, b]), gamma[0][0]) ^ \
                    gfref.gf_mul(int(pages[(l + 1) % A][s * k + 1, b]),
                                 gamma[0][1])
                assert int(row[s, b]) == want


def test_position_pages_layout():
    """Blocks cut along the data dimension, leaves in order, padded."""
    t = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    norm = torch.ones(3)
    tensors = [("layers.0.mlp.w_gate", t), ("layers.0.ln1.scale", norm)]
    p1 = gfref.position_pages(tensors, 1, 4, 2, 16)
    raw = torch.cat([t[2:4].reshape(-1).view(torch.uint8),
                     norm.view(torch.uint8)])
    assert p1.shape == (4, 16)      # 44 bytes, padded to 2 stripes of 2
    assert torch.equal(p1.reshape(-1)[:raw.numel()], raw)
    assert int(p1.reshape(-1)[raw.numel():].sum()) == 0


def test_weights_draw_and_change():
    conf = tiny.config("A", "bfloat16")
    specs = refmodel.leaves(conf)
    a = {s.name: torch.empty(s.shape, dtype=s.dtype) for s in specs}
    b = {s.name: torch.empty(s.shape, dtype=s.dtype) for s in specs}
    weights.fill(a, specs, 11, CPU)
    weights.fill(b, specs, 11, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)
    before = {n: t.clone() for n, t in a.items()}
    change = weights.change_sq(a, specs, 11, CPU)
    assert all(v == 0.0 for v in change.values())
    assert all(torch.equal(a[n], before[n]) for n in a)
    a["embeddings.embed"][0, 0] += 1.0
    assert weights.change_sq(a, specs, 11, CPU)["embeddings.embed"] > 0.9
    weights.fill(b, specs, 12, CPU)
    assert not torch.equal(a["layers.0.attn.wq"], b["layers.0.attn.wq"])


def test_control_reads_further_than_the_program(tmp_path):
    """At test size, bf16: the control (the reference with fp8 products
    in the program's place) reads at least three times the program's
    largest gap on the first gradient, on each of three seeds."""
    root = tiny.root(tmp_path, dtype="bfloat16")
    train = cells.load_module(HERE / "drivers" / "train.py")
    conf = cells.cell(root, "tiny-a.train").config
    specs = refmodel.leaves(conf)
    sound, control = [], []
    for seed in (1, 2, 3):
        line = _run(root, "tiny-a.train", seed)
        assert line["correct"], line["checks"]
        sound.append(line["checks"]["grad_leaf_gap"]["value"])
        batches = traffic.lm_batches(seed, 3, 2, 64, 500, 1.3, CPU)
        ctl = train._reference(conf, specs, seed, CPU, batches, 3,
                               quant="fp8")
        control.append(train.gaps(ctl, line["readings"]["reference"])
                       ["grad_leaf_gap"])
    assert min(control) >= 3 * max(sound), (sound, control)
