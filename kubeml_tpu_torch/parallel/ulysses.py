"""Ulysses all-to-all sequence parallelism over the ``sp`` mesh axis, the
port of ``kubeml_tpu/parallel/ulysses.py``.

One all-to-all re-shards the stacked ``(q, k, v)`` from sequence-sharded
``[B, L/P, H, D]`` to head-sharded ``[B, L, H/P, D]``, every rank runs
ordinary attention over the whole sequence for its head group, and a
second all-to-all swaps back. The local attention is
``ops.attention.dot_product_attention``, so on a CUDA tensor it runs the
hand-written flash kernels (``flash_fwd``, and ``flash_dq``/``flash_dkv``
in the backward) at ``[B, L, H/P, D]``. It needs the local head count
(``num_heads / tp`` under tensor parallelism) divisible by ``P``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import dot_product_attention
from .collectives import all_gather, all_to_all


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp", causal: bool = False,
                      kv_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Exact attention by the head <-> sequence all-to-all: ``q``/``k``/
    ``v`` are this rank's ``[B, Lb, H, D]`` sequence blocks, ``kv_valid
    [B, Lb]`` its keys' validity; returns ``[B, Lb, H, D]``."""
    p = mesh.shape.get(axis_name, 1) if mesh is not None else 1
    h = q.shape[2]
    if h % p != 0:
        # h is the LOCAL head count: num_heads / tp under tensor parallelism
        raise ValueError(
            f"ulysses needs the local (per-tp-shard) head count ({h}) "
            f"divisible by sp ({p})")
    # sequence-sharded -> head-sharded, q/k/v in one all-to-all
    qkv = all_to_all(torch.stack((q, k, v)), mesh, axis_name, split_dim=3,
                     concat_dim=2)
    qh, kh, vh = qkv.unbind(0)  # [B, L, H/P, D]
    valid = (all_gather(kv_valid, mesh, axis_name, dim=1)
             if kv_valid is not None else None)
    # global positions are contiguous after the concat, so causal masking
    # is the one-device semantics
    out = dot_product_attention(qh, kh, vh, causal=causal, kv_valid=valid)
    # head-sharded -> sequence-sharded
    return all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=2)
