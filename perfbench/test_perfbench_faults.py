"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run at test size on the CPU (no look for
a card) with one fault planted in the program, and holds the cell's own
limits: a step that returns its state unchanged, half of the batch left
out (the mean taken over the rest), and an answer altered where it is
produced (a rebuilt byte, half of the rebuilt stripes).  The faults of
the exchange between chips do not apply: every cell runs on one chip.
"""
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from yardstick import harness, tiny  # noqa: E402

CPU = torch.device("cpu")


def _run(root, workload):
    return harness.run_workload(root, workload, 9, 0.2, False, CPU,
                                time.perf_counter())


@pytest.fixture
def root(tmp_path):
    return tiny.root(tmp_path)


def _numbers(line):
    return {k: v["value"] for k, v in line["checks"].items()}


def test_sound_runs_are_correct(root):
    for w in ("tiny-a.train", "tiny-a.recover"):
        line = _run(root, w)
        assert line["correct"], _numbers(line)


def test_state_left_unchanged(root, monkeypatch):
    from repro_torch.train import optimizer
    real = optimizer.adamw

    def frozen(**kw):
        opt = real(**kw)
        return opt._replace(apply=lambda grads, state, params, *a, **k:
                            state)
    monkeypatch.setitem(optimizer.OPTIMIZERS, "adamw", frozen)
    line = _run(root, "tiny-a.train")
    assert not line["correct"]
    assert _numbers(line)["change_leaf_gap"] > 0.5


def test_half_the_batch_left_out(root, monkeypatch):
    from repro_torch.train import train_step
    real = train_step.make_loss_fn

    def half(model):
        fn = real(model)

        def loss_fn(params, batch):
            rows = batch["tokens"].shape[0] // 2
            return fn(params, {k: v[:rows] for k, v in batch.items()})
        return loss_fn
    monkeypatch.setattr(train_step, "make_loss_fn", half)
    line = _run(root, "tiny-a.train")
    assert not line["correct"], _numbers(line)


def test_rebuilt_byte_altered(root, monkeypatch):
    from repro_torch.train.checkpoint import ECCheckpoint
    real = ECCheckpoint.reconstruct

    def flipped(self, state, failed):
        rec = real(self, state, failed).clone()
        rec[..., 7, 3] ^= 1
        return rec
    monkeypatch.setattr(ECCheckpoint, "reconstruct", flipped)
    line = _run(root, "tiny-a.recover")
    assert not line["correct"] and _numbers(line)["rebuilt_bytes_wrong"] > 0


def test_half_the_stripes_left_out(root, monkeypatch):
    from repro_torch.train.checkpoint import ECCheckpoint
    real = ECCheckpoint.reconstruct

    def half(self, state, failed):
        rec = real(self, state, failed).clone()
        rec[..., rec.shape[-2] // 2:, :] = 0
        return rec
    monkeypatch.setattr(ECCheckpoint, "reconstruct", half)
    line = _run(root, "tiny-a.recover")
    assert not line["correct"]


def test_lost_position_read_instead_of_rebuilt(root, monkeypatch):
    """A rebuild that returns the lost position's own pages is caught by
    the real loss after the window."""
    from repro_torch.train.checkpoint import ECCheckpoint

    def copied(self, state, failed):
        pages = self.store.pack(state)
        return pages.select(0, failed).unsqueeze(0).expand(pages.shape)
    monkeypatch.setattr(ECCheckpoint, "reconstruct", copied)
    line = _run(root, "tiny-a.recover")
    assert not line["correct"]
