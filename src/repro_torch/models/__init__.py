"""Model substrate of the port: the dense decoder (layer kind "A"),
prefill through the flash-attention kernel, decode over a KV cache."""
from .config import ModelConfig
from .transformer import Model, apply_layer

__all__ = ["ModelConfig", "Model", "apply_layer"]
