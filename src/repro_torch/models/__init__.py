"""Model substrate of the port: the decoder for every layer kind of the
reference (global and local attention, MLA, MoE, Mamba-2, RG-LRU),
prefill through the flash-attention kernel where attention is unmasked
and causal, decode over a per-layer cache."""
from .config import ModelConfig
from .transformer import Model, apply_layer

__all__ = ["ModelConfig", "Model", "apply_layer"]
