"""The port's HuggingFace importers (``interop/torch_import.py``) against
the JAX package's, on seeded state_dicts of the HF key layouts
(``BertForSequenceClassification`` and ``GPT2LMHeadModel``; no download,
no ``transformers``): the same Flax-layout trees array for array, the
same exports, the round trip, and the imported weights' logits through
the port's models against the JAX models' within 1e-5 (f32; the
frameworks sum in other orders)."""

import jax
import numpy as np
import pytest
import torch

from kubeml_tpu.interop import torch_import as J
from kubeml_tpu.models import bert as jbert
from kubeml_tpu.models import gpt as jgpt
from kubeml_tpu_torch.interop import torch_import as T
from kubeml_tpu_torch.interop.from_flax import from_flax, from_flax_variables
from kubeml_tpu_torch.models import bert as tbert
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.models.layers import load_tree

F32_ATOL = 1e-5
E, M, V, P, DEPTH, C = 128, 256, 1000, 160, 2, 2


def bert_state_dict(seed=0, prefix="bert."):
    r = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy(r.normal(0, 0.05, s).astype(np.float32))
    sd = {f"{prefix}embeddings.word_embeddings.weight": w(V, E),
          f"{prefix}embeddings.position_embeddings.weight": w(P, E),
          f"{prefix}embeddings.token_type_embeddings.weight": w(2, E),
          f"{prefix}embeddings.LayerNorm.weight": 1 + w(E),
          f"{prefix}embeddings.LayerNorm.bias": w(E)}
    for i in range(DEPTH):
        hf = f"{prefix}encoder.layer.{i}"
        for n in ("query", "key", "value"):
            sd[f"{hf}.attention.self.{n}.weight"] = w(E, E)
            sd[f"{hf}.attention.self.{n}.bias"] = w(E)
        sd[f"{hf}.attention.output.dense.weight"] = w(E, E)
        sd[f"{hf}.attention.output.dense.bias"] = w(E)
        sd[f"{hf}.intermediate.dense.weight"] = w(M, E)
        sd[f"{hf}.intermediate.dense.bias"] = w(M)
        sd[f"{hf}.output.dense.weight"] = w(E, M)
        sd[f"{hf}.output.dense.bias"] = w(E)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{hf}.{ln}.weight"] = 1 + w(E)
            sd[f"{hf}.{ln}.bias"] = w(E)
    sd[f"{prefix}pooler.dense.weight"] = w(E, E)
    sd[f"{prefix}pooler.dense.bias"] = w(E)
    sd["classifier.weight"] = w(C, E)
    sd["classifier.bias"] = w(C)
    return sd


GV, GP, GE = 50, 16, 32


def gpt2_state_dict(seed=1):
    r = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy(r.normal(0, 0.05, s).astype(np.float32))
    sd = {"transformer.wte.weight": w(GV, GE),
          "transformer.wpe.weight": w(GP, GE),
          "transformer.ln_f.weight": 1 + w(GE),
          "transformer.ln_f.bias": w(GE)}
    for i in range(DEPTH):
        hf = f"transformer.h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{hf}.{ln}.weight"] = 1 + w(GE)
            sd[f"{hf}.{ln}.bias"] = w(GE)
        sd[f"{hf}.attn.c_attn.weight"] = w(GE, 3 * GE)  # Conv1D: [in, out]
        sd[f"{hf}.attn.c_attn.bias"] = w(3 * GE)
        sd[f"{hf}.attn.c_proj.weight"] = w(GE, GE)
        sd[f"{hf}.attn.c_proj.bias"] = w(GE)
        sd[f"{hf}.mlp.c_fc.weight"] = w(GE, 4 * GE)
        sd[f"{hf}.mlp.c_fc.bias"] = w(4 * GE)
        sd[f"{hf}.mlp.c_proj.weight"] = w(4 * GE, GE)
        sd[f"{hf}.mlp.c_proj.bias"] = w(GE)
    sd["lm_head.weight"] = sd["transformer.wte.weight"].clone()  # tied
    return sd


def bert_pair():
    return jbert.BertTiny(), tbert.BertTiny()


def gpt_pair():
    kw = dict(vocab_size=GV, max_len=GP, embed_dim=GE, depth=DEPTH,
              num_heads=4, attn_bias=True, ln_eps=1e-5)
    return jgpt.CausalTransformer(**kw), CausalTransformer(**kw,
                                                           device="cpu")


def assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(path))


def assert_state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("prefix", ["bert.", ""],
                         ids=["classifier", "encoder-only-dump"])
def test_bert_import_and_export_equal_jax(prefix):
    jm, tm = bert_pair()
    sd = bert_state_dict(prefix=prefix)
    tv, jv = T.import_hf_bert(sd, tm), J.import_hf_bert(sd, jm)
    assert_trees_equal(tv, jv)
    assert_state_dicts_equal(T.export_hf_bert(tv, tm),
                             J.export_hf_bert(jv, jm))


def test_bert_round_trip_and_logits_match_jax():
    jm, tm = bert_pair()
    sd = bert_state_dict(seed=2)
    tv = T.import_hf_bert(sd, tm)
    out = T.export_hf_bert(tv, tm)
    # the token-type-0 row rides in the position embeddings
    type0 = sd["bert.embeddings.token_type_embeddings.weight"][0].numpy()
    for k, v in sd.items():
        if k.endswith("position_embeddings.weight"):
            np.testing.assert_allclose(out[k], v.numpy()[:tm.max_len] + type0,
                                       atol=1e-7, rtol=0)
        elif k.endswith("token_type_embeddings.weight"):
            assert not out[k].any()
        else:
            np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
    assert_trees_equal(T.import_hf_bert(out, tm), tv)
    # the imported tree loads into the port name for name
    v = from_flax_variables(tv, tm)
    tm.load_state_dict(v["params"])
    ids = np.random.default_rng(3).integers(1, V, size=(2, 12)).astype(
        np.int32)
    ids[1, 7:] = 0
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm.apply(J.import_hf_bert(sd, jm),
                                                   ids)),
                               atol=F32_ATOL, rtol=0)


def test_gpt2_import_export_round_trip_and_logits_match_jax():
    jm, tm = gpt_pair()
    sd = gpt2_state_dict()
    tv, jv = T.import_hf_gpt2(sd, tm), J.import_hf_gpt2(sd, jm)
    assert_trees_equal(tv, jv)
    out = T.export_hf_gpt2(tv, tm)
    assert_state_dicts_equal(out, J.export_hf_gpt2(jv, jm))
    assert_state_dicts_equal(out, {k: v.numpy() for k, v in sd.items()})
    load_tree(tm, from_flax(tv))
    ids = np.random.default_rng(4).integers(1, GV, size=(2, GP))
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm.apply(jv, ids, train=False)), atol=F32_ATOL, rtol=0)


def test_mismatched_targets_are_refused():
    _, tm = bert_pair()
    wide = tbert.BertClassifier(vocab_size=V + 1, max_len=128, embed_dim=E,
                                depth=DEPTH, num_heads=2, mlp_dim=M)
    with pytest.raises(ValueError, match="vocab"):
        T.import_hf_bert(bert_state_dict(), wide)
    sd = gpt2_state_dict()
    deep = CausalTransformer(vocab_size=GV, max_len=GP, embed_dim=GE,
                             depth=DEPTH + 1, num_heads=4, attn_bias=True,
                             ln_eps=1e-5, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        T.import_hf_gpt2(sd, deep)
    no_bias = CausalTransformer(vocab_size=GV, max_len=GP, embed_dim=GE,
                                depth=DEPTH, num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="attn_bias"):
        T.import_hf_gpt2(sd, no_bias)
