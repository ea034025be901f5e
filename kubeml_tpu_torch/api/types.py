"""``GenerateRequest``, the port's copy of ``kubeml_tpu/api/types.py``'s
request type for autoregressive sampling, with its validation and caps."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

# Serving-side caps on /generate requests, overridable per deployment
GENERATE_MAX_NEW_TOKENS_CAP = int(os.environ.get("KUBEML_GENERATE_MAX_NEW_TOKENS", "2048"))
GENERATE_MAX_BATCH = int(os.environ.get("KUBEML_GENERATE_MAX_BATCH", "64"))
GENERATE_MAX_PROMPT_LEN = int(os.environ.get("KUBEML_GENERATE_MAX_PROMPT_LEN", "8192"))
# mirrors the engine's top-k width (serving.batcher.TOP_K_MAX)
GENERATE_MAX_TOP_K = int(os.environ.get("KUBEML_GENERATE_MAX_TOP_K", "128"))


@dataclass
class GenerateRequest:
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
