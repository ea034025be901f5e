"""The port's models: the causal transformer with its paged decode branch
and its training forward; the conv models of K-AVG (ResNet, LeNet, VGG);
the encoders (ViT, BERT)."""

from .bert import BertBase, BertClassifier, BertTiny
from .gpt import CausalTransformer, GPTSmall, GPTTiny
from .lenet import LeNet
from .resnet import ResNet, ResNet18, ResNet34, ResNet50
from .vgg import VGG, VGG11
from .vit import ViT, ViTTiny

__all__ = ["BertBase", "BertClassifier", "BertTiny", "CausalTransformer",
           "GPTSmall", "GPTTiny", "LeNet", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "VGG", "VGG11", "ViT", "ViTTiny"]
