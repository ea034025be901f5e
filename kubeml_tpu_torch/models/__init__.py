"""The port's models: the causal transformer with its paged decode branch."""

from .gpt import CausalTransformer, GPTSmall, GPTTiny

__all__ = ["CausalTransformer", "GPTSmall", "GPTTiny"]
