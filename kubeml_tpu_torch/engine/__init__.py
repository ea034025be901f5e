"""The port's K-AVG training engine: ``KAvgTrainer`` (sync rounds on one
card), ``TrainJob`` (the epoch loop) and failure injection."""

from .failures import FailureInjector, WorkerHealth
from .job import TrainJob
from .kavg import KAvgTrainer, RoundPrefetcher

__all__ = ["KAvgTrainer", "RoundPrefetcher", "TrainJob", "FailureInjector",
           "WorkerHealth"]
