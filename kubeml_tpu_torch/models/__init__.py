"""The port's models: the causal transformer with its paged decode branch
and its training forward; the conv models of K-AVG (ResNet, LeNet)."""

from .gpt import CausalTransformer, GPTSmall, GPTTiny
from .lenet import LeNet
from .resnet import ResNet, ResNet18, ResNet34, ResNet50

__all__ = ["CausalTransformer", "GPTSmall", "GPTTiny", "LeNet", "ResNet",
           "ResNet18", "ResNet34", "ResNet50"]
