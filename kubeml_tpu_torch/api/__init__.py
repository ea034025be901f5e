"""Wire-level types of the port: errors, the training types,
``GenerateRequest`` and ``generate_timeout``."""

from .errors import (CheckpointNotFoundError, DataError, DatasetExistsError,
                     DatasetNotFoundError, EngineFaultError,
                     FunctionNotFoundError, InvalidArgsError,
                     JobNotFoundError, KubeMLError, MergeError,
                     OverloadedError, StorageError, error_from_envelope)
from .types import (DatasetSummary, GenerateRequest, History, JobState,
                    MetricUpdate, TrainOptions, TrainRequest,
                    generate_timeout)

__all__ = ["KubeMLError", "OverloadedError", "EngineFaultError",
           "MergeError", "DataError", "StorageError", "DatasetNotFoundError",
           "DatasetExistsError", "JobNotFoundError",
           "CheckpointNotFoundError", "FunctionNotFoundError",
           "InvalidArgsError", "GenerateRequest",
           "TrainOptions", "TrainRequest", "JobState", "MetricUpdate",
           "History", "DatasetSummary", "error_from_envelope",
           "generate_timeout"]
