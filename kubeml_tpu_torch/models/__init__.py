"""The port's models: the causal transformer with its paged decode branch
and its training forward."""

from .gpt import CausalTransformer, GPTSmall, GPTTiny

__all__ = ["CausalTransformer", "GPTSmall", "GPTTiny"]
