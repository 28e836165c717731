"""Whole-model twins of mamba2-370m (Mamba-2) and the two MoE archs,
llama4-maverick-400b-a17b and kimi-k2-1t-a32b: the port's
``Model.apply`` and ``decode_step`` against the JAX package's, with the
reference's own weights.  The procedure and the tolerances are
``test_torch_model_kinds.py``'s (``run_twin``): logits within 1e-4 in
float32, 2e-2 in bfloat16 (or twice the reference's own bf16-vs-fp32
distance where that is larger), the MoE routing of every layer equal at
every token.  mamba2-370m's prefill of 96 tokens runs three SSD chunks
of 32.
"""
import pytest
import torch

from test_torch_model_kinds import run_twin

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "llama4-maverick-400b-a17b",
                                  "kimi-k2-1t-a32b"])
def test_model_kind_matches_reference(arch, dtype, monkeypatch):
    run_twin(arch, dtype, monkeypatch)
