"""Assigned input shapes (per-arch shape set) and their input specs.

The port of the JAX package's ``configs/shapes.py``, without jax.  Four
LM shapes:

  train_4k     seq=4096   global_batch=256   (training step)
  prefill_32k  seq=32768  global_batch=32    (inference prefill)
  decode_32k   seq=32768  global_batch=128   (one-token decode, 32k cache)
  long_500k    seq=524288 global_batch=1     (long-context decode;
               sub-quadratic archs only - full-attention archs SKIP)

``decode_*`` / ``long_*`` are one new token against a seq_len cache
(``Model.decode_step``), not a training step.  ``input_specs`` returns
``InputSpec`` stand-ins (a shape and a torch dtype) where the reference
returns ``jax.ShapeDtypeStruct``s; ``InputSpec.meta()`` makes a meta
tensor of that shape and dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.layers import torch_dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    subquadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           subquadratic_only=True),
}

# families whose serving state is O(1)/O(window) per token
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """One model input's shape and dtype."""
    shape: tuple
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.subquadratic_only and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (f"{shape.name} needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention ({cfg.family}) — "
                       f"skipped per assignment (see DESIGN.md)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``InputSpec`` stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    act = torch_dtype(cfg.dtype)
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.input_mode == "embeddings":
            batch["embeddings"] = InputSpec((B, S, cfg.d_model), act)
        else:
            batch["tokens"] = InputSpec((B, S), i32)
        if cfg.rope_kind == "mrope":
            batch["positions"] = InputSpec((3, B, S), i32)
        if shape.kind == "train":
            batch["labels"] = InputSpec((B, S), i32)
        return batch
    # decode: one new token against a seq_len cache
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["tokens"] = InputSpec((B, 1, cfg.d_model), act)
    else:
        batch["tokens"] = InputSpec((B,), i32)
    if cfg.rope_kind == "mrope":
        batch["positions"] = InputSpec((3, B, 1), i32)
    batch["cur_len"] = InputSpec((), i32)
    return batch
