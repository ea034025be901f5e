"""Flax variables -> the port's weights.

:func:`from_flax` carries a Flax ``CausalTransformer``'s parameters;
:func:`from_flax_variables` a conv model's whole variables tree (ResNet,
LeNet: ``params`` and ``batch_stats``).

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


def from_flax_variables(variables: Mapping[str, Any]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A Flax conv model's variables (``{"params": ..., "batch_stats":
    ...}``, numpy leaves) -> the port's ``{"params": {dotted name: tensor},
    "batch_stats": {dotted name: tensor}}``, the variables format of
    ``runtime.model.KubeModel``. Conv kernels go from Flax's HWIO to
    PyTorch's OIHW; dense kernels (``[in, out]``), BatchNorm ``scale``/
    ``bias`` and the ``mean``/``var`` statistics keep their layout."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for collection, tree in variables.items():
        flat: Dict[str, torch.Tensor] = {}

        def walk(node, prefix: str) -> None:
            if isinstance(node, Mapping):
                for key, child in node.items():
                    walk(child, f"{prefix}.{key}" if prefix else str(key))
            else:
                t = _tensor(node)
                if t.ndim == 4:  # conv kernel [kh, kw, in, out]
                    t = t.permute(3, 2, 0, 1).contiguous()
                flat[prefix] = t

        walk(tree, "")
        out[collection] = flat
    return out
