"""The port's configuration: the settings its K-AVG and serving paths read.

A small own copy of ``kubeml_tpu/api/config.py``'s ``Config``, read from
the same environment variables with the same defaults: the data root
(``KUBEML_DATA_ROOT``, default ``~/.kubeml``) with the dataset, function,
history and checkpoint directories under it, the function-load guardrails
(``KUBEML_FUNCTION_TIMEOUT``, ``KUBEML_FUNCTION_CONCURRENCY``), whether the
K-AVG round also returns its statistical-efficiency signals
(``KUBEML_ROUND_STATS``, default on), and the serving settings the
parameter server builds its paged engines from: slots, chunk, int8
weights and their matmul, pages, prefix cache, chunked prefill, the arena
read and storage, speculative decoding, the admission limit, shed policy,
drain grace, snapshot directory and pool-audit interval, and the
serving mesh (``KUBEML_SERVING_MESH``, an axis spec such as ``tp=2``:
finished models are served over the first ranks of the process group,
:meth:`Config.serving_mesh_axes`).

The control plane's settings come from the same variables too: the bind
address (``KUBEML_HOST``) and the four service ports with their URLs,
the elastic policy's cap and freeze (``KUBEML_MAX_PARALLELISM``,
``LIMIT_PARALLELISM``), the seconds a job waits for the scheduler's
answer at an epoch's end (``KUBEML_UPDATE_TIMEOUT``), the seconds the
leader waits for a follower's start acknowledgement of a job over ranks
(``KUBEML_DIST_ACK_TIMEOUT``), the preempt grace,
the scale-decision log's sizes and the job journal under the data root.

Standalone job runners (``STANDALONE_JOBS``: each job in a runner process
of its own, ``engine/job_runner.py``), their weight channels (the tensor
socket, ``KUBEML_TENSOR_SOCKETS``, at :meth:`Config.job_socket_path`, and
the KMW1 wire's codec, ``KUBEML_DATAPLANE_CODEC``), the native round
packer (``KUBEML_NATIVE_LOADER``), the staging depth
(``KUBEML_DATAPLANE_PREFETCH``) and the preemption monitor
(``KUBEML_PREEMPT_*``, ``scheduler/preemption.py``) take the JAX
package's variables and defaults.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


@dataclass
class Config:
    data_root: Path = field(default_factory=lambda: Path(
        os.environ.get("KUBEML_DATA_ROOT", "~/.kubeml")).expanduser())

    # --- control plane: bind address and service ports (0 = any free
    # port, read back from the bound socket) ---
    host: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_HOST", "127.0.0.1"))
    controller_port: int = field(
        default_factory=lambda: _env_int("KUBEML_CONTROLLER_PORT", 9090))
    scheduler_port: int = field(
        default_factory=lambda: _env_int("KUBEML_SCHEDULER_PORT", 9091))
    ps_port: int = field(
        default_factory=lambda: _env_int("KUBEML_PS_PORT", 9092))
    storage_port: int = field(
        default_factory=lambda: _env_int("KUBEML_STORAGE_PORT", 9093))
    debug: bool = field(
        default_factory=lambda: _env_bool("KUBEML_DEBUG", False))
    # freeze scale-up in the elastic policy
    limit_parallelism: bool = field(
        default_factory=lambda: _env_bool("LIMIT_PARALLELISM", False))
    # run each job in a runner process of its own (the reference's job
    # pod) instead of a thread of the parameter server
    standalone_jobs: bool = field(
        default_factory=lambda: _env_bool("STANDALONE_JOBS", False))
    # pack round slabs through the native parallel packer
    use_native_loader: bool = field(
        default_factory=lambda: _env_bool("KUBEML_NATIVE_LOADER", True))
    # standalone runners publish each epoch's weights into a socket-served
    # native tensor store, which the parameter server reads for a live
    # job's /infer
    tensor_sockets: bool = field(
        default_factory=lambda: _env_bool("KUBEML_TENSOR_SOCKETS", True))
    # the KMW1 weight wire's codec: "raw", "delta" (lossless) or
    # "delta-int8" (int8 deltas with error feedback)
    dataplane_codec: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_DATAPLANE_CODEC", "delta"))
    # rounds staged ahead of the one computing (1: double buffering)
    dataplane_prefetch: int = field(
        default_factory=lambda: _env_int("KUBEML_DATAPLANE_PREFETCH", 1))
    # the policy's cap (None: max(8, the visible cards))
    max_parallelism: Optional[int] = field(default_factory=lambda: (
        int(os.environ["KUBEML_MAX_PARALLELISM"])
        if os.environ.get("KUBEML_MAX_PARALLELISM") else None))
    # seconds the leader waits for each follower's acknowledgement that it
    # built a job over ranks before it fails the job (a follower missing
    # the function or the dataset must fail the start, not hang the first
    # collective)
    dist_ack_timeout: float = field(
        default_factory=lambda: _env_float("KUBEML_DIST_ACK_TIMEOUT", 120.0))
    # seconds the job thread waits for the scheduler's epoch-end answer
    # before it keeps its parallelism
    update_timeout: float = field(
        default_factory=lambda: _env_float("KUBEML_UPDATE_TIMEOUT", 30.0))
    # connect timeout of the port's HTTP client
    http_connect_timeout: float = field(
        default_factory=lambda: _env_float("KUBEML_CONNECT_TIMEOUT", 3.05))
    # bounded retries of idempotent or keyed calls: attempts in all, the
    # backoff's base and cap (seconds, jittered)
    retry_attempts: int = field(
        default_factory=lambda: _env_int("KUBEML_RETRY_ATTEMPTS", 3))
    retry_backoff: float = field(
        default_factory=lambda: _env_float("KUBEML_RETRY_BACKOFF", 0.1))
    retry_backoff_max: float = field(
        default_factory=lambda: _env_float("KUBEML_RETRY_BACKOFF_MAX", 2.0))
    # a destination's retries earn this fraction of its first attempts
    retry_budget: float = field(
        default_factory=lambda: _env_float("KUBEML_RETRY_BUDGET", 0.2))
    # consecutive transport failures that open a destination's circuit,
    # and the open state's cooldown before the half-open probe
    breaker_threshold: int = field(
        default_factory=lambda: _env_int("KUBEML_BREAKER_THRESHOLD", 5))
    breaker_cooldown: float = field(
        default_factory=lambda: _env_float("KUBEML_BREAKER_COOLDOWN", 5.0))
    # seconds a preempted job has to yield before it is abandoned
    preempt_grace: float = field(
        default_factory=lambda: _env_float("KUBEML_PREEMPT_GRACE", 60.0))
    # the preemption monitor: reclaim the card from the lowest-priority
    # training job while serving is overloaded (off by default)
    preempt_monitor: bool = field(
        default_factory=lambda: _env_bool("KUBEML_PREEMPT_MONITOR", False))
    # its poll period (s)
    preempt_interval: float = field(
        default_factory=lambda: _env_float("KUBEML_PREEMPT_INTERVAL", 1.0))
    # overload thresholds, any one crossing counts: queued decode rows,
    # 429s a second over the window, request p99 seconds (0: off)
    preempt_queue_depth: int = field(
        default_factory=lambda: _env_int("KUBEML_PREEMPT_QUEUE_DEPTH", 8))
    preempt_overload_rate: float = field(
        default_factory=lambda: _env_float("KUBEML_PREEMPT_OVERLOAD_RATE",
                                           1.0))
    preempt_p99: float = field(
        default_factory=lambda: _env_float("KUBEML_PREEMPT_P99", 0.0))
    # consecutive overloaded polls before a preemption, consecutive calm
    # polls before the parked jobs requeue
    preempt_sustain: int = field(
        default_factory=lambda: _env_int("KUBEML_PREEMPT_SUSTAIN", 3))
    preempt_resume_sustain: int = field(
        default_factory=lambda: _env_int("KUBEML_PREEMPT_RESUME_SUSTAIN", 5))
    # seconds between two preemptions
    preempt_cooldown: float = field(
        default_factory=lambda: _env_float("KUBEML_PREEMPT_COOLDOWN", 30.0))
    # scale-decision audit: newest decisions a job, jobs kept
    decision_log_size: int = field(
        default_factory=lambda: _env_int("KUBEML_DECISION_LOG_SIZE", 64))
    decision_log_jobs: int = field(
        default_factory=lambda: _env_int("KUBEML_DECISION_LOG_JOBS", 256))
    # per-round [worker-loss spread, pre-merge weight divergence]
    round_stats: bool = field(
        default_factory=lambda: _env_bool("KUBEML_ROUND_STATS", True))
    # seconds a function load may run before it is abandoned (<= 0: no
    # limit), and the loads that may run at once
    function_timeout: float = field(default_factory=lambda: float(
        os.environ.get("KUBEML_FUNCTION_TIMEOUT", "1000")))
    function_concurrency: int = field(
        default_factory=lambda: _env_int("KUBEML_FUNCTION_CONCURRENCY", 50))

    # --- serving: the parameter server's engines ---
    # batch concurrent generate requests through a resident engine (False:
    # each request runs the one-shot generate_from_request)
    serving_batcher: bool = field(
        default_factory=lambda: _env_bool("KUBEML_SERVING_BATCHER", True))
    serving_slots: int = field(
        default_factory=lambda: _env_int("KUBEML_SERVING_SLOTS", 8))
    serving_chunk_steps: int = field(
        default_factory=lambda: _env_int("KUBEML_SERVING_CHUNK", 16))
    # "int8": int8 weights (a final-int8 checkpoint when it is at least as
    # fresh as the final, else the final quantized at load); "" = off
    serving_quantize: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SERVING_QUANTIZE", ""))
    # int8 projections through the int8 matmul (else dequantized weights)
    int8_matmul: bool = field(
        default_factory=lambda: _env_bool("KUBEML_INT8_MATMUL", False))
    # "auto" (the CUDA kernel on CUDA tensors), "cuda"/"pallas", "dot"
    int8_matmul_impl: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_INT8_MATMUL_IMPL", "auto"))
    # an axis spec such as "tp=2": serve finished models over that many
    # ranks of the process group ("" = one rank; an invalid or oversized
    # spec logs and serves on one rank)
    serving_mesh: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SERVING_MESH", ""))
    # the paged engine for the models it decodes (False: the dense slot
    # engine); a serving mesh always takes the dense engine
    serving_paged: bool = field(
        default_factory=lambda: _env_bool("KUBEML_SERVING_PAGED", True))
    serving_page_tokens: int = field(
        default_factory=lambda: _env_int("KUBEML_SERVING_PAGE_TOKENS", 16))
    # arena pages including the trash page (0 = slots x table pages + 1)
    serving_pages: int = field(
        default_factory=lambda: _env_int("KUBEML_SERVING_PAGES", 0))
    serving_prefix_cache: bool = field(
        default_factory=lambda: _env_bool("KUBEML_SERVING_PREFIX_CACHE",
                                          True))
    # prefill suffixes longer than this in page-aligned chunks (0 = off)
    prefill_chunk_tokens: int = field(
        default_factory=lambda: _env_int("KUBEML_PREFILL_CHUNK_TOKENS", 0))
    # the arena read: "auto" (the CUDA kernel on CUDA), "cuda"/"pallas",
    # "gather"; and its storage: "off", "int8", "auto"
    paged_attn: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_PAGED_ATTN", "auto"))
    kv_quant: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_KV_QUANT", "off"))
    # speculative decoding: "off", "self" (early exit at spec_exit_layer,
    # 0 = depth // 2) or "draft" (spec_draft_model, a finished job id)
    serving_spec: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SERVING_SPEC", "off"))
    spec_k: int = field(default_factory=lambda: _env_int("KUBEML_SPEC_K", 4))
    spec_adaptive: bool = field(
        default_factory=lambda: _env_bool("KUBEML_SPEC_ADAPTIVE", True))
    spec_draft_model: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SPEC_DRAFT_MODEL", ""))
    spec_exit_layer: int = field(
        default_factory=lambda: _env_int("KUBEML_SPEC_EXIT_LAYER", 0))
    # the draft backend's acceptance floor (0 = off)
    spec_min_accept: float = field(default_factory=lambda: float(
        os.environ.get("KUBEML_SPEC_MIN_ACCEPT", "0.10")))
    # queued rows past this limit are refused with 429 (0 = unbounded)
    serving_queue_limit: int = field(default_factory=lambda: int(
        os.environ.get("KUBEML_SERVING_QUEUE_LIMIT") or 256))
    # at the limit: "reject" refuses the NEW request, "oldest" sheds the
    # longest-queued request (its waiter gets the 429) and admits the new
    serving_shed_policy: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SERVING_SHED", "reject"))
    # seconds drain() gives live rows to finish before snapshotting them
    drain_grace: float = field(default_factory=lambda: float(
        os.environ.get("KUBEML_DRAIN_GRACE", "20")))
    # where drained KMS1 frames land ("" = no cross-process hop)
    snap_dir: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SNAP_DIR", ""))
    # seconds between KVPool.check() audits of the engine loop (0 = off)
    pool_audit_interval: float = field(default_factory=lambda: float(
        os.environ.get("KUBEML_POOL_AUDIT_INTERVAL", "0")))

    def serving_mesh_axes(self) -> dict:
        """Parsed ``serving_mesh`` ({} when unset), in the ``ax=n[,ax=n]``
        syntax of the CLI's ``--mesh`` (``parallel.mesh.parse_mesh_spec``);
        a malformed spec raises ``ValueError``."""
        from ..parallel.mesh import parse_mesh_spec

        return parse_mesh_spec(self.serving_mesh)

    def job_socket_path(self, job_id: str) -> Path:
        """The unix socket of a standalone job's tensor server, under the
        system temporary directory (a socket path holds at most ~107
        bytes) in a directory named by a digest of the data root, so two
        clusters do not collide. The directory is made mode 0700 and its
        owner checked: the socket carries no authentication, so another
        user must not be able to bind its name and serve weights."""
        import hashlib
        import tempfile

        ns = hashlib.md5(str(self.data_root).encode()).hexdigest()[:8]
        d = Path(tempfile.gettempdir()) / f"kubeml-{ns}"
        d.mkdir(mode=0o700, exist_ok=True)
        st = d.stat()
        if st.st_uid != os.getuid():
            raise PermissionError(
                f"socket directory {d} is owned by uid {st.st_uid}, not us "
                f"({os.getuid()}); refusing to exchange weights through it")
        os.chmod(d, 0o700)  # an existing directory made looser
        return d / f"{job_id}.sock"

    @property
    def logs_dir(self) -> Path:
        return self.data_root / "logs"

    @property
    def datasets_dir(self) -> Path:
        return self.data_root / "datasets"

    @property
    def functions_dir(self) -> Path:
        return self.data_root / "functions"

    @property
    def history_path(self) -> Path:
        return self.data_root / "history"

    @property
    def checkpoints_dir(self) -> Path:
        return self.data_root / "checkpoints"

    @property
    def journal_dir(self) -> Path:
        return self.data_root / "journal"

    @property
    def advertise_host(self) -> str:
        """The address clients dial: a wildcard bind is not dialable."""
        return "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host

    @property
    def controller_url(self) -> str:
        return f"http://{self.advertise_host}:{self.controller_port}"

    @property
    def scheduler_url(self) -> str:
        return f"http://{self.advertise_host}:{self.scheduler_port}"

    @property
    def ps_url(self) -> str:
        return f"http://{self.advertise_host}:{self.ps_port}"

    @property
    def storage_url(self) -> str:
        return f"http://{self.advertise_host}:{self.storage_port}"

    def ensure_dirs(self) -> None:
        for d in (self.datasets_dir, self.functions_dir, self.history_path,
                  self.checkpoints_dir):
            d.mkdir(parents=True, exist_ok=True)


_default_config: Optional[Config] = None


def get_config() -> Config:
    """Process-wide default config (constructed from the environment at
    first use)."""
    global _default_config
    if _default_config is None:
        _default_config = Config()
    return _default_config


def set_config(cfg: Config) -> None:
    global _default_config
    _default_config = cfg
