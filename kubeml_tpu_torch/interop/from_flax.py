"""Flax ``CausalTransformer`` variables -> the port's weights.

The port's modules carry Flax's parameter names and layouts (dense kernels
``[in, out]``, LayerNorm ``scale``/``bias``, ``token_embed.embedding``,
``pos_embed [1, max_len, E]``), so converting a tree is a flatten: nested
names join with ``.``. The Flax tree names are

    token_embed/embedding, pos_embed,
    block_{i}/{ln1,ln2}/{scale,bias},
    block_{i}/attn/{query,key,value,proj}/{kernel,bias?},
    block_{i}/{mlp_in,mlp_out}/{kernel,bias},
    ln_f/{scale,bias}, lm_head/kernel

and become ``block_0.attn.query.kernel`` and so on. Leaves must be numpy
arrays (callers unbox ``nn.Partitioned`` leaves and ``np.asarray`` them on
the JAX side). An int8 pair - any node with fields ``q`` and ``s``, such as
``kubeml_tpu.serving.quant.QuantizedTensor`` - becomes the port's
:class:`~kubeml_tpu_torch.serving.quant.QuantizedTensor`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..serving.quant import QuantizedTensor


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def from_flax(variables: Mapping[str, Any]) -> Dict[str, object]:
    """Flatten a Flax variables tree (with or without the top-level
    ``params`` collection) into ``{dotted name: tensor | QuantizedTensor}``,
    ready for :func:`kubeml_tpu_torch.models.layers.load_tree`."""
    tree = variables.get("params", variables)
    out: Dict[str, object] = {}

    def walk(node, prefix: str) -> None:
        if hasattr(node, "q") and hasattr(node, "s"):
            out[prefix] = QuantizedTensor(q=_tensor(node.q), s=_tensor(node.s))
        elif isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, f"{prefix}.{key}" if prefix else str(key))
        else:
            out[prefix] = _tensor(node)

    walk(tree, "")
    return out
