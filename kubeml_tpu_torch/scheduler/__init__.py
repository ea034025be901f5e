"""The port's scheduler: the task queue, the elastic parallelism policy
and its decision log, and the scheduler loop with its HTTP surface."""

from .decisions import REASONS, DecisionLog, ScaleDecision
from .policy import SchedulerPolicy, ThroughputBasedPolicy
from .queue import TaskQueue, TenantUsage
from .scheduler import Scheduler

__all__ = ["Scheduler", "SchedulerPolicy", "ThroughputBasedPolicy",
           "TaskQueue", "TenantUsage", "DecisionLog", "ScaleDecision",
           "REASONS"]
