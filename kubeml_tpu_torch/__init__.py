"""kubeml_tpu_torch - the PyTorch + CUDA port of ``kubeml_tpu``'s paged
serving path and GPT training path, for NVIDIA Hopper (H100).

Each module sits at the same sub-path as its JAX twin in ``kubeml_tpu`` and
keeps that package's public tensor layouts (q ``[B, L, H, D]``, KV arenas
``[N, page_tokens, H, D]`` with scales ``[N, H]``, dense kernels
``[in, out]``), so the two can be held against each other on the same
inputs. The port imports nothing of ``kubeml_tpu`` or JAX.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device on a host without CUDA they raise (:func:`resolve_device`).

* ``api`` - errors and ``GenerateRequest``;
* ``interop.from_flax`` - a Flax ``CausalTransformer`` variables tree to the
  port's weights;
* ``ops`` - attention, RoPE, and the hand-written CUDA kernels
  (``paged_attention``, ``int8_matmul``, ``flash_attention``'s forward, dQ
  and dK/dV) beside their plain versions;
* ``models`` - the causal transformer with its paged decode branch and
  rematerialised training forward;
* ``parallel`` - ``SPMDTrainer`` on one card with the LM losses;
* ``benchmarks`` - the long-context training benchmark;
* ``serving`` - int8 weight quantization, the page pool, and the paged
  continuous-batching engine ``PagedBatchingDecoder``.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
