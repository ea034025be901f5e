"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py):
tiny JAX models and their PyTorch twins carrying the same weights.

Inputs are made from numpy seeds and handed to both frameworks as numpy
arrays; weights travel Flax -> numpy -> ``interop.from_flax``."""

import flax.linen as nn
import jax
import numpy as np

from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
from kubeml_tpu_torch.interop.from_flax import from_flax
from kubeml_tpu_torch.models import CausalTransformer
from kubeml_tpu_torch.models.layers import load_tree

VOCAB = 101


def jax_tiny(pos="learned", max_len=48, **kw):
    """The JAX suite's tiny config (vocab 101, E 32, depth 2, H 2)."""
    return JaxTransformer(vocab_size=VOCAB, max_len=max_len, embed_dim=32,
                          depth=2, num_heads=2, pos=pos, **kw)


def jax_init(module, seed=0):
    return module.init(jax.random.PRNGKey(seed), np.zeros((1, 8), np.int32))


def numpy_tree(variables):
    """Unbox ``nn.Partitioned`` leaves and bring every leaf to numpy."""
    return jax.tree.map(np.asarray, nn.meta.unbox(variables))


def torch_twin(jm, variables):
    """The port's CausalTransformer with ``jm``'s config and weights, on
    the CPU."""
    tm = CausalTransformer(vocab_size=jm.vocab_size, max_len=jm.max_len,
                           embed_dim=jm.embed_dim, depth=jm.depth,
                           num_heads=jm.num_heads, mlp_ratio=jm.mlp_ratio,
                           ln_eps=jm.ln_eps, attn_bias=jm.attn_bias,
                           pos=jm.pos, rope_theta=jm.rope_theta,
                           device="cpu")
    return load_tree(tm, from_flax(numpy_tree(variables)))
