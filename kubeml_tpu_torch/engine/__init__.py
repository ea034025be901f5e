"""The port's training engines: ``KAvgTrainer`` (sync rounds on one
card), ``TrainJob`` (the K-AVG epoch loop), failure injection, and
``SPMDJob`` (the SPMD engine's job), dispatched by :func:`job_class_for`."""

from .failures import FailureInjector, WorkerHealth
from .job import TrainJob
from .kavg import KAvgTrainer, RoundPrefetcher

__all__ = ["KAvgTrainer", "RoundPrefetcher", "TrainJob", "FailureInjector",
           "WorkerHealth", "job_class_for"]


def job_class_for(options):
    """The job class of ``options.engine``: the one dispatch point of the
    parameter server (JAX :5)."""
    if options.engine == "spmd":
        from .spmd_job import SPMDJob

        return SPMDJob
    return TrainJob
