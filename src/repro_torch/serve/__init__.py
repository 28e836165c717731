"""serve subpackage: batched generation on the port's ``Model``."""
from .engine import GenerationResult, ServeEngine, greedy_generate

__all__ = ["GenerationResult", "ServeEngine", "greedy_generate"]
