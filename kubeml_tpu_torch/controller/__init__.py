"""The port's controller (the REST gateway) and its Python client."""

from .client import KubemlClient
from .controller import Controller

__all__ = ["Controller", "KubemlClient"]
