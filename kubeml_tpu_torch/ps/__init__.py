"""The port's parameter server: the serving half (finished-job
``generate``/``infer``, drain and restore) and its metrics."""

from .metrics import MetricsRegistry
from .parameter_server import ParameterServer

__all__ = ["ParameterServer", "MetricsRegistry"]
