"""The port's controller (the REST gateway) and its Python client."""

from .client import KubemlClient

__all__ = ["Controller", "KubemlClient"]


def __getattr__(name):
    # the gateway (stores, registry, torch) is imported on first use: the
    # client alone starts without torch
    if name == "Controller":
        from .controller import Controller

        return Controller
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
