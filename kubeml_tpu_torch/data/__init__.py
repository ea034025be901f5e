"""The port's K-AVG data path: datasets, shard/round planning and the
round loader (numpy on the host; slabs reach the card through
``engine.kavg.KAvgTrainer.stage_round``)."""

from .dataset import KubeDataset, TrainParams
from .loader import RoundBatch, RoundLoader, build_round, validation_loader
from .sharding import (RoundPlan, plan_epoch, plan_eval, split_minibatches,
                       subset_period)

__all__ = ["KubeDataset", "TrainParams", "RoundBatch", "RoundLoader",
           "build_round", "validation_loader", "RoundPlan", "plan_epoch",
           "plan_eval", "split_minibatches", "subset_period"]
