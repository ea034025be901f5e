"""Wire-level types of the port: errors and ``GenerateRequest``."""

from .errors import EngineFaultError, KubeMLError, OverloadedError
from .types import GenerateRequest

__all__ = ["KubeMLError", "OverloadedError", "EngineFaultError",
           "GenerateRequest"]
