"""The port's data paths: the K-AVG datasets, shard/round planning and the
round loader (numpy on the host; slabs reach the card through
``engine.kavg.KAvgTrainer.stage_round``), and text corpora packed to token
rows (``data.text``, ``data.bpe``).

The names below are imported on first use, so that the text path (which
the CLI reads) needs neither the stores nor torch."""

_EXPORTS = {
    "KubeDataset": "dataset", "TrainParams": "dataset",
    "RoundBatch": "loader", "RoundLoader": "loader",
    "build_round": "loader", "validation_loader": "loader",
    "RoundPlan": "sharding", "plan_epoch": "sharding",
    "plan_eval": "sharding", "split_minibatches": "sharding",
    "subset_period": "sharding",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
