"""Wire-level types of the port: errors, the training types and
``GenerateRequest``."""

from .errors import (DataError, DatasetExistsError, DatasetNotFoundError,
                     EngineFaultError, JobNotFoundError, KubeMLError,
                     MergeError, OverloadedError, StorageError,
                     error_from_envelope)
from .types import (DatasetSummary, GenerateRequest, History, JobState,
                    MetricUpdate, TrainOptions, TrainRequest)

__all__ = ["KubeMLError", "OverloadedError", "EngineFaultError",
           "MergeError", "DataError", "StorageError", "DatasetNotFoundError",
           "DatasetExistsError", "JobNotFoundError", "GenerateRequest",
           "TrainOptions", "TrainRequest", "JobState", "MetricUpdate",
           "History", "DatasetSummary", "error_from_envelope"]
