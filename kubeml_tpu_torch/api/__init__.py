"""Wire-level types of the port: errors, the training and control-plane
types, ``GenerateRequest`` and ``generate_timeout``."""

from .errors import (CheckpointNotFoundError, DataError, DatasetExistsError,
                     DatasetNotFoundError, EngineFaultError,
                     FunctionNotFoundError, InvalidArgsError,
                     InvalidFormatError,
                     JobNotFoundError, KubeMLError, MergeError,
                     OverloadedError, StorageError, error_from_envelope)
from .types import (DatasetSummary, GenerateRequest, History, InferRequest,
                    JobInfo, JobState, JobStateEnum, JobTaskType,
                    MetricUpdate, TrainOptions, TrainRequest, TrainTask,
                    generate_timeout, parse_grace_seconds)

__all__ = ["KubeMLError", "OverloadedError", "EngineFaultError",
           "MergeError", "DataError", "StorageError", "DatasetNotFoundError",
           "DatasetExistsError", "JobNotFoundError",
           "CheckpointNotFoundError", "FunctionNotFoundError",
           "InvalidArgsError", "InvalidFormatError", "GenerateRequest",
           "InferRequest", "TrainOptions", "TrainRequest", "TrainTask",
           "JobState", "JobStateEnum", "JobTaskType", "JobInfo",
           "MetricUpdate", "History", "DatasetSummary",
           "error_from_envelope", "generate_timeout", "parse_grace_seconds"]
