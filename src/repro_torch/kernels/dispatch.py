"""Device-aware kernel dispatch policy (the port's single seam).

The policy is decided by where the data lies, never by a flag:

* a **CUDA tensor** goes to the hand-written kernel (``"cuda-kernel"``);
  if the kernel cannot launch, the wrapper raises;
* a **CPU tensor** goes to the kernel's plain PyTorch version
  (``"torch-cpu"``).

There is no interpret mode and no environment variable that sends CUDA
tensors to the plain version.  ``TorchEngine`` runs the plain versions
on purpose, on any device, and records ``"torch-plain"`` so that a run
on the card that never reached a kernel shows it.

``decide()`` returns the path a kernel call takes; engines surface it in
``CodingEngine.describe()``/``stats()``/``op_paths`` so a run can always
answer "did the kernels run?".

Inside ``dry_run()`` (``launch/dryrun.py`` only) a ``meta`` device is let
through too: a model, its optimizer state and its inputs are built on it
with nothing allocated, and a kernel call on a meta tensor (``"meta"``)
gives its output's shape (``flash_attention``'s fake implementation, the
shared-matrix product's ``gf256_matmul._meta_product``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

# dispatch paths
CUDA = "cuda-kernel"        # hand-written CUDA kernel, launched on the card
TORCH_CPU = "torch-cpu"     # the kernel's plain torch version, CPU tensors
PLAIN = "torch-plain"       # TorchEngine: plain torch versions on purpose
META = "meta"               # shapes only, inside ``dry_run()``

_dry = threading.local()


@contextlib.contextmanager
def dry_run():
    """Let ``meta`` devices through ``resolve_device`` and ``decide`` in
    this thread, for the dry run's shape-only builds."""
    prev = getattr(_dry, "on", False)
    _dry.on = True
    try:
        yield
    finally:
        _dry.on = prev


def _meta_ok(dev: torch.device) -> bool:
    return dev.type == "meta" and getattr(_dry, "on", False)


@dataclasses.dataclass(frozen=True)
class Decision:
    """How a kernel call runs: ``path`` is CUDA or TORCH_CPU (META in a
    dry run)."""
    path: str

    @property
    def kernel(self) -> bool:
        return self.path == CUDA


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Asking for CUDA on a host without a card raises; nothing carries on
    silently on the CPU.  Pass ``device="cpu"`` to run there.
    """
    dev = torch.device("cuda" if device is None else device)
    if _meta_ok(dev):
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or the "
            "engine name 'torch:cpu' / 'numpy') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _device(where) -> torch.device:
    return where.device if isinstance(where, torch.Tensor) \
        else torch.device(where)


_DECISIONS = {"cuda": Decision(CUDA), "cpu": Decision(TORCH_CPU)}
_META_DECISION = Decision(META)


def decide(where) -> Decision:
    """Resolve the dispatch path for one kernel call on ``where``, the
    tensor (or device) the call operates on."""
    dev = _device(where)
    try:
        return _DECISIONS[dev.type]
    except KeyError:
        if _meta_ok(dev):
            return _META_DECISION
        raise ValueError(f"no kernel path for device {dev}") from None


def describe(where) -> dict:
    """Policy snapshot for ``engine.describe()`` / run provenance."""
    return {"backend": _device(where).type, "path": decide(where).path}
