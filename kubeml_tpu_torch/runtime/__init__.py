"""The user-facing model API of the port (``KubeModel``)."""

from .model import KubeModel

__all__ = ["KubeModel"]
