"""HuggingFace checkpoints into the port: a copy of
``kubeml_tpu/interop/torch_import.py``.

A migrating user's most valuable asset is a trained PyTorch checkpoint, so
this module converts HuggingFace ``state_dict`` layouts to the Flax
variables layout both packages share (the port loads it with
``interop.from_flax.from_flax_variables`` or ``from_flax``):

* generic layout converters (`linear_kernel_from_torch`,
  `conv_kernel_from_torch`) for hand-built mappings: PyTorch stores Linear
  weights ``[out, in]`` and Conv2d weights ``[O, I, kH, kW]``; the Flax
  layout is ``[in, out]`` and HWIO ``[kH, kW, I, O]``;
* `import_hf_bert`/`export_hf_bert`: a HuggingFace
  ``BertForSequenceClassification`` state_dict onto
  :class:`kubeml_tpu_torch.models.bert.BertClassifier` variables and back;
* `import_hf_gpt2`/`export_hf_gpt2`: ``GPT2LMHeadModel`` onto
  :class:`kubeml_tpu_torch.models.gpt.CausalTransformer` and back.

Everything operates on plain numpy: the trees returned are the JAX
package's, array for array, so a checkpoint imported here loads into
either package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _np(t: Any) -> np.ndarray:
    """Accept PyTorch tensors or numpy arrays."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def linear_kernel_from_torch(weight: Any) -> np.ndarray:
    """torch ``nn.Linear.weight`` [out, in] → flax Dense kernel [in, out]."""
    return _np(weight).T


def conv_kernel_from_torch(weight: Any) -> np.ndarray:
    """torch ``nn.Conv2d.weight`` [O, I, kH, kW] → flax Conv kernel HWIO
    [kH, kW, I, O] (the Flax layout of the variables trees)."""
    return np.transpose(_np(weight), (2, 3, 1, 0))


def _dense_general(weight: Any, bias: Any, heads: int, head_dim: int, *,
                   out_heads: bool) -> Dict[str, np.ndarray]:
    """HF [E, E] attention projection → our DenseGeneral shapes.

    out_heads=True: q/k/v projections, kernel [E, H, D], bias [H, D].
    out_heads=False: output projection, kernel [H, D, E], bias [E]."""
    w = linear_kernel_from_torch(weight)  # [in, out]
    e_in, e_out = w.shape
    if out_heads:
        return {"kernel": w.reshape(e_in, heads, head_dim),
                "bias": _np(bias).reshape(heads, head_dim)}
    return {"kernel": w.reshape(heads, head_dim, e_out), "bias": _np(bias)}


def _layer_norm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _dense(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": linear_kernel_from_torch(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def import_hf_bert(state_dict: Mapping[str, Any], model) -> Dict[str, Any]:
    """Map a HuggingFace ``BertForSequenceClassification`` state_dict onto a
    :class:`~kubeml_tpu_torch.models.bert.BertClassifier`'s variables.

    ``model`` is the target BertClassifier (its config must match the
    checkpoint: depth, heads, embed_dim, mlp_dim, vocab, max_len). Returns a
    fresh ``{"params": ...}`` tree in the Flax layout.

    Architectural deltas handled here:
    * HF adds word + position + token-type embeddings; this model has no
      token-type input, so the type-0 embedding row is folded into the
      position embeddings (single-segment equivalence).
    * HF prefixes may or may not include the leading ``bert.`` (encoder-only
      dumps); both are accepted.
    """
    sd = dict(state_dict)
    if not any(k.startswith("bert.") for k in sd):
        sd = {f"bert.{k}" if not k.startswith("classifier") else k: v
              for k, v in sd.items()}

    H = model.num_heads
    D = model.embed_dim // H

    word = _np(sd["bert.embeddings.word_embeddings.weight"])  # [V, E]
    pos = _np(sd["bert.embeddings.position_embeddings.weight"])  # [max_len, E]
    type0 = _np(sd["bert.embeddings.token_type_embeddings.weight"])[0]  # [E]
    if word.shape != (model.vocab_size, model.embed_dim):
        raise ValueError(
            f"checkpoint vocab/embed {word.shape} != model "
            f"({model.vocab_size}, {model.embed_dim})"
        )
    if pos.shape[0] < model.max_len:
        raise ValueError(
            f"checkpoint max positions {pos.shape[0]} < model.max_len {model.max_len}"
        )

    params: Dict[str, Any] = {
        "token_embed": {"embedding": word},
        "pos_embed": (pos[: model.max_len] + type0[None, :])[None],  # [1, L, E]
        "LayerNorm_0": _layer_norm(sd, "bert.embeddings.LayerNorm"),
        "pooler": _dense(sd, "bert.pooler.dense"),
        "Dense_0": _dense(sd, "classifier"),
    }
    for i in range(model.depth):
        hf = f"bert.encoder.layer.{i}"
        params[f"BertLayer_{i}"] = {
            "BertSelfAttention_0": {
                "query": _dense_general(sd[f"{hf}.attention.self.query.weight"],
                                        sd[f"{hf}.attention.self.query.bias"],
                                        H, D, out_heads=True),
                "key": _dense_general(sd[f"{hf}.attention.self.key.weight"],
                                      sd[f"{hf}.attention.self.key.bias"],
                                      H, D, out_heads=True),
                "value": _dense_general(sd[f"{hf}.attention.self.value.weight"],
                                        sd[f"{hf}.attention.self.value.bias"],
                                        H, D, out_heads=True),
                "output": _dense_general(sd[f"{hf}.attention.output.dense.weight"],
                                         sd[f"{hf}.attention.output.dense.bias"],
                                         H, D, out_heads=False),
            },
            "LayerNorm_0": _layer_norm(sd, f"{hf}.attention.output.LayerNorm"),
            "Dense_0": _dense(sd, f"{hf}.intermediate.dense"),
            "Dense_1": _dense(sd, f"{hf}.output.dense"),
            "LayerNorm_1": _layer_norm(sd, f"{hf}.output.LayerNorm"),
        }
    return {"params": params}


def export_hf_bert(variables: Mapping[str, Any], model) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_hf_bert`: a BertClassifier variables pytree →
    a HuggingFace ``BertForSequenceClassification``-shaped state_dict of numpy
    arrays (wrap with ``torch.from_numpy`` to load into torch).

    The position embeddings carry the folded token-type-0 row (see
    import_hf_bert), so the export writes them as-is and zero token-type
    embeddings — logits-equivalent for single-segment inputs. max positions
    beyond ``model.max_len`` cannot be reconstructed and are exported at
    ``model.max_len``."""
    p = variables["params"]
    H = model.num_heads
    E = model.embed_dim

    def lin(d: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"weight": np.asarray(d["kernel"]).T.copy(),
                "bias": np.asarray(d["bias"]).copy()}

    def ln(d: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"weight": np.asarray(d["scale"]).copy(),
                "bias": np.asarray(d["bias"]).copy()}

    out: Dict[str, np.ndarray] = {}

    def put(prefix: str, d: Dict[str, np.ndarray]) -> None:
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

    out["bert.embeddings.word_embeddings.weight"] = np.asarray(
        p["token_embed"]["embedding"]).copy()
    out["bert.embeddings.position_embeddings.weight"] = np.asarray(
        p["pos_embed"])[0].copy()
    out["bert.embeddings.token_type_embeddings.weight"] = np.zeros(
        (2, E), np.float32)
    put("bert.embeddings.LayerNorm", ln(p["LayerNorm_0"]))

    for i in range(model.depth):
        attn = p[f"BertLayer_{i}"]["BertSelfAttention_0"]
        hf = f"bert.encoder.layer.{i}"
        for ours, theirs in (("query", "query"), ("key", "key"), ("value", "value")):
            put(f"{hf}.attention.self.{theirs}", {
                "weight": np.asarray(attn[ours]["kernel"]).reshape(E, E).T.copy(),
                "bias": np.asarray(attn[ours]["bias"]).reshape(E).copy(),
            })
        put(f"{hf}.attention.output.dense", {
            "weight": np.asarray(attn["output"]["kernel"]).reshape(E, E).T.copy(),
            "bias": np.asarray(attn["output"]["bias"]).copy(),
        })
        layer = p[f"BertLayer_{i}"]
        put(f"{hf}.attention.output.LayerNorm", ln(layer["LayerNorm_0"]))
        put(f"{hf}.intermediate.dense", lin(layer["Dense_0"]))
        put(f"{hf}.output.dense", lin(layer["Dense_1"]))
        put(f"{hf}.output.LayerNorm", ln(layer["LayerNorm_1"]))

    put("bert.pooler.dense", lin(p["pooler"]))
    put("classifier", lin(p["Dense_0"]))
    return out


def import_hf_gpt2(state_dict: Mapping[str, Any], model) -> Dict[str, Any]:
    """Map a HuggingFace ``GPT2LMHeadModel`` state_dict onto a
    :class:`~kubeml_tpu_torch.models.gpt.CausalTransformer`'s variables.

    ``model`` must be built GPT-2-compatible: ``attn_bias=True, ln_eps=1e-5``
    and matching vocab/max_len/embed_dim/depth/num_heads —
    ``GPTSmall(vocab_size=50257, max_len=1024, attn_bias=True, ln_eps=1e-5)``
    covers gpt2-124M. Returns ``{"params": ...}`` in the Flax layout.

    Mapping notes:
    * HF GPT-2 ``Conv1D`` weights are ALREADY ``[in, out]`` (not torch
      ``Linear``'s ``[out, in]``), so kernels pass through untransposed;
      ``c_attn`` fuses q/k/v along the output axis and is split in thirds.
    * The LM head is weight-tied to ``wte`` upstream; here it becomes an
      untied ``lm_head.kernel = wte.T`` (logits-identical at import time).
    * This model reserves token id 0 as padding (attention-masked); GPT-2
      has no pad id, so supply inputs without id 0 for exact parity.
    * gelu matches (HF ``gelu_new`` == flax tanh-approximate gelu).
    """
    sd = {k.removeprefix("transformer."): v for k, v in dict(state_dict).items()}
    E = model.embed_dim
    if getattr(model, "attn_bias", False) is not True or model.ln_eps != 1e-5:
        raise ValueError(
            "target CausalTransformer must be built with attn_bias=True, "
            "ln_eps=1e-5 for GPT-2 parity"
        )

    wte = _np(sd["wte.weight"])  # [V, E]
    wpe = _np(sd["wpe.weight"])  # [P, E]
    if wte.shape != (model.vocab_size, E):
        raise ValueError(
            f"checkpoint vocab/embed {wte.shape} != model "
            f"({model.vocab_size}, {E})"
        )
    if wpe.shape[0] < model.max_len:
        raise ValueError(
            f"checkpoint max positions {wpe.shape[0]} < model.max_len "
            f"{model.max_len}"
        )
    n_layers = 1 + max(
        (int(k.split(".")[1]) for k in sd if k.startswith("h.")), default=-1
    )
    if n_layers != model.depth:
        raise ValueError(
            f"checkpoint has {n_layers} layers but model.depth is "
            f"{model.depth} — a silent truncation would produce garbage logits"
        )

    params: Dict[str, Any] = {
        "token_embed": {"embedding": wte},
        "pos_embed": wpe[: model.max_len][None],  # [1, L, E]
        "ln_f": _layer_norm(sd, "ln_f"),
        "lm_head": {"kernel": wte.T.copy()},  # untied from the tied HF head
    }
    for i in range(model.depth):
        hf = f"h.{i}"
        ca = _np(sd[f"{hf}.attn.c_attn.weight"])  # Conv1D: [E, 3E]
        cab = _np(sd[f"{hf}.attn.c_attn.bias"])   # [3E]
        qw, kw, vw = np.split(ca, 3, axis=1)
        qb, kb, vb = np.split(cab, 3)
        params[f"block_{i}"] = {
            "ln1": _layer_norm(sd, f"{hf}.ln_1"),
            "ln2": _layer_norm(sd, f"{hf}.ln_2"),
            "attn": {
                "query": {"kernel": qw, "bias": qb},
                "key": {"kernel": kw, "bias": kb},
                "value": {"kernel": vw, "bias": vb},
                "proj": {"kernel": _np(sd[f"{hf}.attn.c_proj.weight"]),
                         "bias": _np(sd[f"{hf}.attn.c_proj.bias"])},
            },
            "mlp_in": {"kernel": _np(sd[f"{hf}.mlp.c_fc.weight"]),
                       "bias": _np(sd[f"{hf}.mlp.c_fc.bias"])},
            "mlp_out": {"kernel": _np(sd[f"{hf}.mlp.c_proj.weight"]),
                        "bias": _np(sd[f"{hf}.mlp.c_proj.bias"])},
        }
    return {"params": params}


def export_hf_gpt2(variables: Mapping[str, Any], model) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_hf_gpt2`: a CausalTransformer variables pytree
    → a ``GPT2LMHeadModel``-shaped state_dict of numpy arrays (Conv1D layout,
    q/k/v re-fused; ``lm_head.weight`` exported from ``wte`` per HF tying —
    a fine-tuned untied lm_head would diverge and is exported as the tied
    embedding, matching how HF loads gpt2 checkpoints)."""
    p = variables["params"]

    def ln(d):
        return {"weight": np.asarray(d["scale"]).copy(),
                "bias": np.asarray(d["bias"]).copy()}

    out: Dict[str, np.ndarray] = {}

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

    wte = np.asarray(p["token_embed"]["embedding"]).copy()
    out["transformer.wte.weight"] = wte
    out["transformer.wpe.weight"] = np.asarray(p["pos_embed"])[0].copy()
    put("transformer.ln_f", ln(p["ln_f"]))
    out["lm_head.weight"] = wte.copy()

    for i in range(model.depth):
        blk = p[f"block_{i}"]
        hf = f"transformer.h.{i}"
        put(f"{hf}.ln_1", ln(blk["ln1"]))
        put(f"{hf}.ln_2", ln(blk["ln2"]))
        attn = blk["attn"]
        out[f"{hf}.attn.c_attn.weight"] = np.concatenate(
            [np.asarray(attn[n]["kernel"]) for n in ("query", "key", "value")],
            axis=1).copy()
        out[f"{hf}.attn.c_attn.bias"] = np.concatenate(
            [np.asarray(attn[n]["bias"]) for n in ("query", "key", "value")]).copy()
        out[f"{hf}.attn.c_proj.weight"] = np.asarray(attn["proj"]["kernel"]).copy()
        out[f"{hf}.attn.c_proj.bias"] = np.asarray(attn["proj"]["bias"]).copy()
        out[f"{hf}.mlp.c_fc.weight"] = np.asarray(blk["mlp_in"]["kernel"]).copy()
        out[f"{hf}.mlp.c_fc.bias"] = np.asarray(blk["mlp_in"]["bias"]).copy()
        out[f"{hf}.mlp.c_proj.weight"] = np.asarray(blk["mlp_out"]["kernel"]).copy()
        out[f"{hf}.mlp.c_proj.bias"] = np.asarray(blk["mlp_out"]["bias"]).copy()
    return out
