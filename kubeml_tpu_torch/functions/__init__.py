"""The port's function registry: user model files under the data root."""

from .registry import FunctionRegistry, FunctionSummary

__all__ = ["FunctionRegistry", "FunctionSummary"]
