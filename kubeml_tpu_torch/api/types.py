"""Wire types of the port: the port's copy of ``kubeml_tpu/api/types.py``'s
training types (``TrainOptions``, ``TrainRequest``, ``JobState``,
``TrainTask``, ``MetricUpdate``, ``History``, ``DatasetSummary``,
``JobInfo``), the lifecycle enums (``JobTaskType``, ``JobStateEnum``),
``InferRequest``, ``GenerateRequest`` and ``parse_grace_seconds``.

They read and write the same JSON as the JAX package's types, with the same
validation. A request may name options whose modules the port does not
have yet, or that the cluster's ranks cannot hold;
:meth:`TrainOptions.check_ported` raises for those (a 400 naming the
item that lifts it), and the port's jobs and scheduler call it with the
cluster's world before a job starts. :func:`generate_timeout` is the
budget a caller waits on one generate request.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .errors import KubeMLError

# the JAX package's default data-parallel worker count
DEFAULT_PARALLELISM = 4

# dataset shard granularity: 64-sample logical docs drive the K-interval
# and shard-range math (data/sharding.py)
STORAGE_SUBSET_SIZE = 64

# Serving-side caps on /generate requests, overridable per deployment
GENERATE_MAX_NEW_TOKENS_CAP = int(os.environ.get("KUBEML_GENERATE_MAX_NEW_TOKENS", "2048"))
GENERATE_MAX_BATCH = int(os.environ.get("KUBEML_GENERATE_MAX_BATCH", "64"))
GENERATE_MAX_PROMPT_LEN = int(os.environ.get("KUBEML_GENERATE_MAX_PROMPT_LEN", "8192"))
# mirrors the engine's top-k width (serving.batcher.TOP_K_MAX)
GENERATE_MAX_TOP_K = int(os.environ.get("KUBEML_GENERATE_MAX_TOP_K", "128"))


class JobTaskType:
    """Dispatch values of a function invocation."""

    INIT = "init"
    TRAIN = "train"
    VALIDATE = "val"
    INFER = "infer"


class JobStateEnum:
    """Lifecycle states of a train task. ``PREEMPTED``: the job wrote a
    resume checkpoint and gave its device back; it is requeued with
    ``resume=True``."""

    QUEUED = "queued"
    STARTING = "starting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    STOPPED = "stopped"
    PREEMPTED = "preempted"


class _JsonMixin:
    """JSON (de)serialization shared by the wire types."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def parse_request(cls, d: Dict[str, Any]):
        """``from_dict`` for wire handlers: validation failures surface as
        a 400 ``KubeMLError``."""
        try:
            return cls.from_dict(d)
        except (ValueError, TypeError) as e:
            raise KubeMLError(f"invalid {cls.__name__}: {e}", 400)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclass
class TrainOptions(_JsonMixin):
    """Tunables of a training job.

    ``k`` is the K-AVG sync period in local steps: workers run K optimizer
    steps on their shard, then their weights are averaged. ``k == -1`` means
    one sync per epoch."""

    default_parallelism: int = DEFAULT_PARALLELISM
    static_parallelism: bool = False
    validate_every: int = 1
    k: int = 16
    goal_accuracy: float = 100.0
    # "kavg" = elastic local SGD; "spmd" = synchronous mesh training (over
    # the cluster's ranks: check_ported refuses a mesh that does not fit)
    engine: str = "kavg"
    goal_loss: float = 0.0
    precision: str = "bf16"  # compute dtype of the inputs ("bf16" | "f32")
    # {"worker": d} caps the devices the workers span; other axes belong to
    # the SPMD engine
    mesh_shape: Optional[Dict[str, int]] = None
    donate: bool = True  # read by the JAX engine; the port updates in place
    # a checkpoint every this many epochs (0 = off), keeping the newest
    # checkpoint_keep of them (0 = all)
    checkpoint_every: int = 0
    checkpoint_keep: int = 0
    # restart from the job's newest checkpoint
    resume: bool = False
    sharded_checkpoints: bool = False
    # export the final model at job end (the "final" checkpoint)
    save_model: bool = True
    chaos_prob: float = 0.0  # per-worker per-round failure probability
    priority: int = 0
    tenant: str = ""

    def __post_init__(self):
        if self.goal_loss < 0.0:
            raise ValueError(f"goal_loss must be >= 0 (0 = off), got {self.goal_loss}")
        if self.engine not in ("kavg", "spmd"):
            raise ValueError(f"engine must be 'kavg' or 'spmd', got {self.engine!r}")
        if self.validate_every < 0:
            raise ValueError("validate_every must be >= 0")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if self.checkpoint_keep < 0:
            raise ValueError("checkpoint_keep must be >= 0")
        if not (0.0 <= self.chaos_prob <= 1.0):
            raise ValueError("chaos_prob must be in [0, 1]")
        if self.k == 0 or self.k < -1:
            raise ValueError("k must be -1 (sparse) or a positive step count")
        if (isinstance(self.priority, bool) or not isinstance(self.priority, int)
                or not (0 <= self.priority <= 1000)):
            raise ValueError("priority must be an integer in [0, 1000]")
        if self.tenant and not re.fullmatch(r"[A-Za-z0-9._-]{1,64}", self.tenant):
            raise ValueError("tenant must be 1-64 chars of [A-Za-z0-9._-]")
        if self.mesh_shape is not None:
            for axis, size in self.mesh_shape.items():
                if not isinstance(size, int) or size < 1:
                    raise ValueError(
                        f"mesh_shape[{axis!r}] must be a positive int, got {size!r}"
                    )

    def check_ported(self, world: int = 1) -> None:
        """Raise ``KubeMLError`` (400) for an option a job of this package
        cannot run on a cluster of ``world`` ranks, each refusal naming
        the item of the port (ROADMAP Queue 1) that lifts it: an SPMD
        mesh that does not divide the world (``mesh_shape_for`` with
        ``dp`` filling the rest), a ``pp`` axis above 1 (the pipeline,
        item 1.2) or an ``ep`` axis above 1 (MoE expert sharding, item
        1.3), and a K-AVG job over several ranks or with a mesh axis
        other than ``worker`` above 1 (multi-card K-AVG, item 1.5)."""
        shape = dict(self.mesh_shape or {})
        if self.engine != "spmd":
            if world > 1:
                raise KubeMLError(
                    f"not ported to kubeml_tpu_torch yet: a K-AVG job on a "
                    f"cluster of {world} ranks (multi-card K-AVG, ROADMAP "
                    f"Queue 1 item 1.5); run it on one rank, or as an "
                    f"--engine spmd job", 400)
            if any(int(n) > 1 for ax, n in shape.items() if ax != "worker"):
                raise KubeMLError(
                    f"not ported to kubeml_tpu_torch yet: mesh_shape "
                    f"{shape} on a K-AVG job spans several devices "
                    f"(multi-card K-AVG, ROADMAP Queue 1 item 1.5)", 400)
            return
        for ax, item in (("pp", "the pipeline, ROADMAP Queue 1 item 1.2"),
                         ("ep", "MoE expert sharding over ep, ROADMAP "
                                "Queue 1 item 1.3")):
            if int(shape.get(ax, 1)) > 1:
                raise KubeMLError(
                    f"not ported to kubeml_tpu_torch yet: mesh_shape {shape}"
                    f" with {ax} > 1 ({item})", 400)
        from ..parallel.mesh import mesh_shape_for

        try:
            mesh_shape_for(world, **{ax: int(n) for ax, n in shape.items()})
        except ValueError as e:
            raise KubeMLError(
                f"mesh_shape {shape} does not fit a cluster of {world} "
                f"rank(s) ({e}); a multi-card SPMD job runs on a cluster "
                f"over as many ranks (kubeml start on every rank, with "
                f"KUBEML_COORDINATOR, KUBEML_NUM_PROCESSES and "
                f"KUBEML_PROCESS_ID set)", 400)


@dataclass
class TrainRequest(_JsonMixin):
    """A user request to train a model."""

    model_type: str = ""
    batch_size: int = 64
    epochs: int = 1
    dataset: str = ""
    lr: float = 0.01
    function_name: str = ""
    options: TrainOptions = field(default_factory=TrainOptions)
    job_id: str = ""

    def __post_init__(self):
        if isinstance(self.options, dict):
            self.options = TrainOptions.from_dict(self.options)

    def validate(self) -> None:
        if not self.function_name:
            raise ValueError("function_name is required")
        if self.job_id and not re.fullmatch(r"[A-Za-z0-9_-]{1,64}", self.job_id):
            raise ValueError("job_id must be 1-64 chars of [A-Za-z0-9_-]")
        if not self.dataset:
            raise ValueError("dataset is required")
        if self.epochs < 1:
            raise ValueError("epochs must be >= 1")
        if not (0 < self.batch_size <= 1024):
            raise ValueError("batch_size must be in (0, 1024]")


@dataclass
class InferRequest(_JsonMixin):
    """Inference against a trained job's model."""

    model_id: str = ""
    data: Any = None


def parse_grace_seconds(grace) -> Optional[float]:
    """The optional ``grace`` of a preempt or drain body: None passes
    through (the server's default), anything else must be a number >= 0
    (a 400 otherwise)."""
    if grace is None:
        return None
    if isinstance(grace, bool) or not isinstance(grace, (int, float)):
        raise KubeMLError("grace must be a number of seconds", 400)
    grace = float(grace)
    if not (grace >= 0.0):  # rejects negatives and NaN
        raise KubeMLError("grace must be >= 0 seconds", 400)
    return grace


@dataclass
class JobState(_JsonMixin):
    """Per-epoch state a job reports to the scheduler's parallelism
    policy."""

    parallelism: int = 0
    elapsed_time: float = -1.0  # seconds of the last epoch; -1 on first call


@dataclass
class TrainTask(_JsonMixin):
    """A scheduled training task: controller -> scheduler -> PS -> job.
    ``trace_parent`` is carried for the JAX package's wire format; the
    port records no traces."""

    job_id: str = ""
    parameters: TrainRequest = field(default_factory=TrainRequest)
    state: JobState = field(default_factory=JobState)
    status: str = JobStateEnum.QUEUED
    started_at: float = field(default_factory=time.time)
    trace_parent: str = ""

    def __post_init__(self):
        if isinstance(self.parameters, dict):
            self.parameters = TrainRequest.from_dict(self.parameters)
        if isinstance(self.state, dict):
            self.state = JobState.from_dict(self.state)


@dataclass
class MetricUpdate(_JsonMixin):
    """Metrics a job pushes each epoch (the JAX package's fields; those the
    port's K-AVG engine does not measure keep their "not measured"
    defaults)."""

    job_id: str = ""
    validation_loss: float = 0.0
    accuracy: float = 0.0
    train_loss: float = 0.0
    parallelism: int = 0
    epoch_duration: float = 0.0
    epoch: int = -1  # 1-based count of epochs completed; -1 = not reported
    moe_overflow: float = -1.0
    round_seconds: List[float] = field(default_factory=list)
    merge_seconds: float = -1.0
    round_divergence: List[float] = field(default_factory=list)
    round_loss_spread: List[float] = field(default_factory=list)
    round_skew_ratio: float = -1.0
    dataplane: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class History(_JsonMixin):
    """A job's training history, persisted at job end. The signal lists
    (divergence, loss spread, round skew) are NaN in memory for an epoch
    that measured nothing and cross the wire as JSON null."""

    id: str = ""
    task: Optional[Dict[str, Any]] = None
    validation_loss: List[float] = field(default_factory=list)
    accuracy: List[float] = field(default_factory=list)
    train_loss: List[float] = field(default_factory=list)
    parallelism: List[int] = field(default_factory=list)
    epoch_duration: List[float] = field(default_factory=list)
    worker_divergence: List[float] = field(default_factory=list)
    loss_spread: List[float] = field(default_factory=list)
    round_skew: List[float] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    _SIGNAL_LISTS = ("worker_divergence", "loss_spread", "round_skew")

    def __post_init__(self):
        for name in self._SIGNAL_LISTS:
            vals = getattr(self, name)
            if any(v is None for v in vals):
                setattr(self, name,
                        [math.nan if v is None else float(v) for v in vals])

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        for name in self._SIGNAL_LISTS:
            d[name] = [None if isinstance(v, float) and math.isnan(v) else v
                       for v in d[name]]
        return d

    def append_epoch(
        self,
        train_loss: float,
        parallelism: int,
        duration: float,
        validation_loss: Optional[float] = None,
        accuracy: Optional[float] = None,
        worker_divergence: Optional[float] = None,
        loss_spread: Optional[float] = None,
        round_skew: Optional[float] = None,
    ) -> None:
        self.train_loss.append(float(train_loss))
        self.parallelism.append(int(parallelism))
        self.epoch_duration.append(float(duration))
        if validation_loss is not None:
            self.validation_loss.append(float(validation_loss))
        if accuracy is not None:
            self.accuracy.append(float(accuracy))
        if worker_divergence is not None:
            self.worker_divergence.append(float(worker_divergence))
        if loss_spread is not None:
            self.loss_spread.append(float(loss_spread))
        if round_skew is not None:
            self.round_skew.append(float(round_skew))


@dataclass
class DatasetSummary(_JsonMixin):
    """Dataset listing entry: sample counts of the two splits."""

    name: str = ""
    train_set_size: int = 0
    test_set_size: int = 0


@dataclass
class JobInfo(_JsonMixin):
    """The PS's record of a live job."""

    job_id: str = ""
    status: str = JobStateEnum.STARTING
    parallelism: int = 0
    function_name: str = ""
    dataset: str = ""


@dataclass
class GenerateRequest(_JsonMixin):
    """Autoregressive sampling against a causal LM.

    ``prompts`` rows are DENSE token ids: decode treats every token as real.
    Ragged batches pass ``prompt_lengths`` (one true length per row; tokens
    past it are ignored)."""

    model_id: str = ""
    prompts: Any = None          # [B, Lp] int token ids (dense unless prompt_lengths)
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 = greedy; > 0 requires an explicit seed
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None   # required when temperature > 0
    prompt_lengths: Optional[Any] = None
    # stream=True: the engine yields per-chunk token deltas
    stream: bool = False

    def __post_init__(self):
        # bool is excluded explicitly: JSON `true` must not coerce to 1
        for name in ("max_new_tokens", "top_k", "eos_id", "seed"):
            v = getattr(self, name)
            if v is not None and (isinstance(v, bool) or not isinstance(v, int)):
                raise ValueError(f"{name} must be an integer, got {type(v).__name__}")
        if isinstance(self.temperature, bool) or not isinstance(self.temperature, (int, float)):
            raise ValueError("temperature must be a number")
        if not isinstance(self.stream, bool):
            raise ValueError("stream must be a boolean")
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        if self.max_new_tokens > GENERATE_MAX_NEW_TOKENS_CAP:
            raise ValueError(
                f"max_new_tokens exceeds the serving cap "
                f"({GENERATE_MAX_NEW_TOKENS_CAP}; KUBEML_GENERATE_MAX_NEW_TOKENS)")
        if self.top_k is not None and self.top_k <= 0:
            raise ValueError("top_k must be positive")
        if self.top_k is not None and self.top_k > GENERATE_MAX_TOP_K:
            raise ValueError(
                f"top_k exceeds the serving cap "
                f"({GENERATE_MAX_TOP_K}; KUBEML_GENERATE_MAX_TOP_K)")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.temperature > 0 and self.seed is None:
            # a silent default seed would return the identical "sample" on
            # every request
            raise ValueError("temperature > 0 requires an explicit seed")
        if self.prompts is not None:
            try:
                batch = len(self.prompts)
                longest = max((len(r) for r in self.prompts), default=0)
            except TypeError:
                raise ValueError("prompts must be a [batch, prompt_len] token array")
            if batch > GENERATE_MAX_BATCH:
                raise ValueError(
                    f"prompt batch exceeds the serving cap "
                    f"({GENERATE_MAX_BATCH}; KUBEML_GENERATE_MAX_BATCH)")
            if longest > GENERATE_MAX_PROMPT_LEN:
                raise ValueError(
                    f"prompt length exceeds the serving cap "
                    f"({GENERATE_MAX_PROMPT_LEN}; KUBEML_GENERATE_MAX_PROMPT_LEN)")
            if self.prompt_lengths is not None:
                pl = self.prompt_lengths
                if (not isinstance(pl, (list, tuple)) or len(pl) != batch
                        or any(isinstance(v, bool) or not isinstance(v, int)
                               for v in pl)):
                    raise ValueError(
                        "prompt_lengths must be one integer per prompt row")
                if any(v < 1 or v > longest for v in pl):
                    raise ValueError(
                        "prompt_lengths entries must be in [1, prompt width]")


def generate_timeout(req: "GenerateRequest", floor: float = 120.0) -> float:
    """Seconds to wait on one generate request: the first call on a card
    builds the kernels, and decode time grows with tokens x batch, so the
    budget scales with the request instead of a flat constant."""
    batch = 1
    try:
        batch = max(1, len(req.prompts))
    except TypeError:
        pass
    return max(floor, 60.0 + 0.05 * req.max_new_tokens * batch)
