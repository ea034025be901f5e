"""kubeml_tpu_torch - the PyTorch + CUDA port of ``kubeml_tpu``'s paged
serving path, GPT training path, K-AVG training path and control plane,
for NVIDIA Hopper (H100).

Each module sits at the same sub-path as its JAX twin in ``kubeml_tpu`` and
keeps that package's public tensor layouts (q ``[B, L, H, D]``, KV arenas
``[N, page_tokens, H, D]`` with scales ``[N, H]``, dense kernels
``[in, out]``), so the two can be held against each other on the same
inputs. The port imports nothing of ``kubeml_tpu`` or JAX.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device on a host without CUDA they raise (:func:`resolve_device`).

* ``api`` - errors, the training wire types (``TrainRequest``,
  ``History``, ...), ``GenerateRequest`` and a small ``Config``;
* ``interop.from_flax`` - a Flax ``CausalTransformer``'s, ResNet's or
  LeNet's variables tree to the port's weights;
* ``ops`` - attention, RoPE, and the hand-written CUDA kernels
  (``paged_attention``, ``int8_matmul``, ``flash_attention``'s forward, dQ
  and dK/dV) beside their plain versions;
* ``models`` - the causal transformer with its paged decode branch and
  rematerialised training forward; ResNet-18/34/50 and LeNet with Flax's
  numerics (SAME padding, BatchNorm statistics, initialisers);
* ``runtime`` - ``KubeModel``, the user-facing model API;
* ``storage`` - the dataset ``ShardStore`` and the ``HistoryStore``, in the
  JAX package's on-disk formats;
* ``data`` - ``KubeDataset``, shard and round planning, the round loader;
  ``data.text`` and ``data.bpe``, a text corpus packed to token rows with
  the byte tokenizer or a BPE trained on it;
* ``engine`` - K-AVG: ``KAvgTrainer`` (local SGD on N workers, then the
  mask-weighted average; on one card the workers run in a Python loop),
  ``TrainJob`` (the elastic epoch loop) and failure injection;
* ``parallel`` - ``SPMDTrainer`` on one card with the LM losses;
* ``benchmarks`` - the long-context training benchmark and the K-AVG
  flagship's (``harness``);
* ``serving`` - int8 weight quantization, the page pool, and the paged
  continuous-batching engine ``PagedBatchingDecoder``;
* ``ps``, ``scheduler``, ``controller``, ``storage.service``, ``cluster``
  and ``cli`` - the control plane over HTTP (``utils.httpd``, the standard
  library's server; ``utils.http_client``, its client, every call under
  ``utils.resilience``'s retries, breakers and chaos): the parameter
  server's job lifecycle and serving routes, the elastic scheduler, the
  REST gateway with ``KubemlClient``, ``LocalCluster`` and
  ``python -m kubeml_tpu_torch.cli``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # imported on first use, so that the CLI's client commands, which need
    # no tensor, start without importing torch
    if name == "resolve_device":
        from .utils.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
