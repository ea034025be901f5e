"""The port's parameter server: the training lifecycle of threaded jobs,
the serving half (finished-job ``generate``/``infer``, drain and restore),
its metrics, the job journal and the HTTP surface."""

from .journal import JobJournal
from .metrics import MetricsRegistry
from .parameter_server import ParameterServer

__all__ = ["ParameterServer", "MetricsRegistry", "JobJournal"]
