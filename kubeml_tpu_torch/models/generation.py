"""Decode-side helpers of the port, from ``kubeml_tpu/models/generation.py``:
the dense and the paged KV caches, the paged-decode capability probe, the
one-shot ``generate`` (prefill then per-token steps through the dense
cache) with its wire entry ``generate_from_request``, the one-shot
speculative path (``make_speculative_generate_fn``, ``generate(spec=...)``:
prefill, drafts and verifies through a paged cache of its own), the per-row
knob-adjusted logits the samplers draw from, and the acceptance math of
speculative decoding (``draft_sample``, ``spec_accept``,
``spec_mask_emissions``), which the serving engine's spec mode runs too.

``generate`` is eager: there is no compiled program per knob combination
to cache, so the JAX LRU of programs has no counterpart.

Randomness: the JAX functions take a PRNG key per row; here a row that
samples (temperature > 0) carries its own ``torch.Generator`` and a greedy
row carries None. A row's draws come from its generator alone, in a fixed
order, so its stream does not depend on the rows it is batched with.
Greedy rows are exact (argmax); sampled rows keep the target distribution
(accept a draft with probability min(1, p/q), resample the residual), as
the JAX functions do, but not the JAX key chain's values."""

from __future__ import annotations

import inspect
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.paged_attention import resolve_kv_quant, resolve_paged_attn
from .gpt import PAD_ID
from .layers import fold_in, make_generator, seed_of

__all__ = ["PAD_ID", "GenerationInputError", "GenerateResult",
           "SpecGenerateResult", "DenseCache", "init_cache", "generate",
           "make_generate_fn", "make_speculative_generate_fn",
           "generate_from_request", "PagedCache", "init_paged_cache",
           "supports_paged_decode", "draft_sample", "spec_accept",
           "spec_mask_emissions"]

# width of the top-k threshold scratch for runtime per-row knobs (the
# serving bound, serving.batcher.TOP_K_MAX)
SPEC_TOP_K_CAP = 128


class GenerationInputError(ValueError):
    """A USER-input problem in a generation request (bad shapes, a model
    that cannot serve): the wire layer maps exactly this type to 400."""


class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_new_tokens] int64; PAD_ID after EOS
    lengths: torch.Tensor  # [B] int64: tokens generated incl. EOS (or cap)


class SpecGenerateResult(NamedTuple):
    """A speculative run's result and its acceptance accounting."""

    tokens: torch.Tensor   # [B, max_new_tokens] int64; PAD_ID padded
    lengths: torch.Tensor  # [B] int64
    proposed: int          # candidates verified (k + 1 a live row a step)
    accepted: int          # drafted tokens that passed acceptance
    drafted: int           # tokens the drafter sampled (k a live row a step)
    steps: int             # verify steps run


class DenseCache:
    """The dense KV cache of ``CausalTransformer``'s decode (JAX ``cache``
    collection without pages): ``layers[i]`` holds ``k``/``v`` ``[B, Lc,
    H, D]`` in the compute dtype and ``valid [B, Lc]`` bool; ``index`` is
    the shared cursor of the scalar-cursor path (the next write
    position). The forward updates it in place."""

    def __init__(self, layers: List[Dict[str, torch.Tensor]],
                 index: int = 0):
        self.layers = layers
        self.index = index


def init_cache(module, batch: int,
               cache_len: Optional[int] = None) -> DenseCache:
    """A zeroed dense cache for ``batch`` rows of ``cache_len`` positions
    (default ``module.max_len``), cursor 0, on the module's device. Over a
    mesh it holds this rank's heads, ``num_heads / tp`` (JAX's slab
    head-sharded over ``tp``)."""
    Lc = int(cache_len if cache_len is not None else module.max_len)
    mesh = getattr(module, "mesh", None)
    D = module.embed_dim // module.num_heads
    H = module.num_heads // (1 if mesh is None else mesh.shape.get("tp", 1))
    dev = module.device
    layers = [{"k": torch.zeros((batch, Lc, H, D), dtype=module.dtype,
                                device=dev),
               "v": torch.zeros((batch, Lc, H, D), dtype=module.dtype,
                                device=dev),
               "valid": torch.zeros((batch, Lc), dtype=torch.bool,
                                    device=dev)}
              for _ in range(module.depth)]
    return DenseCache(layers)


def _sample(logits: torch.Tensor, gen: Optional[torch.Generator],
            temperature: float, top_k: Optional[int]) -> torch.Tensor:
    """One next-token draw per row from ``[B, V]`` f32 logits: the argmax
    when greedy, else a draw from ``gen`` over the temperature-scaled,
    top-k-truncated softmax."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / float(temperature)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=gen)[:, 0]


def make_generate_fn(module, *, max_new_tokens: int,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     eos_id: Optional[int] = None):
    """The ``(prompt_ids, gen) -> GenerateResult`` callable behind
    :func:`generate` (JAX :311): prefill the whole prompt in one dense
    decode call (cursor 0 -> Lp), sample, then one call a token. Rows that
    emitted ``eos_id`` keep feeding their last token (the cache stays
    well formed) and output ``PAD_ID``; ``lengths`` counts the live
    emissions (a live row may emit id 0, a vocab token)."""

    @torch.inference_mode()
    def run(prompt_ids: torch.Tensor,
            gen: Optional[torch.Generator]) -> GenerateResult:
        B, Lp = prompt_ids.shape
        cap = getattr(module, "max_len", None)
        if cap is None:
            raise GenerationInputError(
                "model exposes no max_len attribute; generation requires a "
                "declared KV-cache capacity (CausalTransformer sets it)")
        # the last sampled token is returned but never written back
        if Lp + max_new_tokens - 1 > cap:
            raise GenerationInputError(
                f"prompt ({Lp}) + max_new_tokens ({max_new_tokens}) - 1 "
                f"exceeds the model's max_len ({cap})")
        cache = init_cache(module, B)
        logits = module(prompt_ids, decode=True, cache=cache)
        tok = _sample(logits[:, -1].float(), gen, temperature, top_k)
        done = (torch.zeros_like(tok, dtype=torch.bool) if eos_id is None
                else tok == eos_id)
        outs, lives = [tok], []
        for _ in range(max_new_tokens - 1):
            logits = module(tok[:, None], decode=True, cache=cache)
            nxt = _sample(logits[:, -1].float(), gen, temperature, top_k)
            was_live = ~done
            if eos_id is not None:
                done = done | (was_live & (nxt == eos_id))
            outs.append(torch.where(was_live, nxt,
                                    torch.full_like(nxt, PAD_ID)))
            lives.append(was_live)
            tok = torch.where(was_live, nxt, tok)
        tokens = torch.stack(outs, dim=1)
        lengths = 1 + (torch.stack(lives, dim=1).sum(dim=1) if lives
                       else torch.zeros(B, dtype=torch.int64,
                                        device=tokens.device))
        return GenerateResult(tokens, lengths)

    return run


def make_speculative_generate_fn(module, *, max_new_tokens: int,
                                 spec: str = "self", spec_k: int = 4,
                                 draft_module=None,
                                 exit_layer: Optional[int] = None,
                                 temperature: float = 0.0,
                                 top_k: Optional[int] = None,
                                 eos_id: Optional[int] = None,
                                 page_tokens: int = 16,
                                 kv_quant: str = "off",
                                 paged_attn: str = "auto"):
    """Speculative decoding for the one-shot path (JAX :381): a
    ``(prompt_ids, rng=None) -> SpecGenerateResult`` callable.

    ``spec="draft"`` drafts with ``draft_module`` (a small causal LM with
    its own weights) through a paged cache of its own; ``spec="self"``
    drafts with the target's first ``exit_layer`` blocks (default half
    the depth), which share the target's arena: the drafter writes layers
    < ``exit_layer``, the verify rewrites those positions with the same
    bytes and fills the rest.

    Each call builds the JAX geometry for its ``(B, Lp)``: ``total =
    min(Lp + max_new_tokens - 1 + k, max_len)`` positions a row, one
    private table of ``ceil(total / page_tokens)`` pages a row, page 0
    the trash page that dead rows and positions past the table write to.
    A step drafts k tokens a live row (L 1 forwards; the draft backend
    runs one more, write-only, so the k-th draft's K/V lands in its
    arena), verifies all k+1 positions in one L k+1 forward,
    ``spec_accept`` keeps the leading run of accepted drafts and one
    correction, and ``spec_mask_emissions`` clips at eos and the budget.
    Rollback is positional: the next step's window overwrites a rejected
    suffix. Greedy tokens are the plain argmax chain; sampled rows keep
    the target distribution, each row drawing from its own generator
    (``fold_in(seed, row)``). ``kv_quant`` and ``paged_attn`` are the
    arena's storage and read path (``init_paged_cache``); the JAX module
    carries them as fields."""
    if spec not in ("self", "draft"):
        raise ValueError(f"unknown spec backend {spec!r} "
                         f"(valid: 'self', 'draft')")
    if spec_k < 1:
        raise ValueError("spec_k must be >= 1")
    if not supports_paged_decode(module):
        raise GenerationInputError(
            "speculative decoding runs on the paged decode path; the module "
            "has none (positions/pages/seq_lens/cache forward arguments)")
    if spec == "draft":
        if draft_module is None:
            raise ValueError("spec='draft' needs a draft_module")
        if not supports_paged_decode(draft_module):
            raise GenerationInputError("draft module has no paged decode path")
        if getattr(draft_module, "vocab_size", None) != \
                getattr(module, "vocab_size", None):
            raise GenerationInputError(
                "draft and target models must share one vocabulary")
    depth = getattr(module, "depth", None)
    if spec == "self":
        exit_layer = (int(exit_layer) if exit_layer
                      else max(1, (depth or 2) // 2))
        if depth is not None and not 1 <= exit_layer <= depth:
            raise ValueError(
                f"exit_layer must be in [1, depth={depth}], got {exit_layer}")
    cap = getattr(module, "max_len", None)
    if cap is None:
        raise GenerationInputError(
            "model exposes no max_len attribute; generation requires a "
            "declared KV-cache capacity")
    pt = int(page_tokens)
    k = int(spec_k)
    if temperature <= 0.0:
        top_k = None  # greedy ignores top_k
    if spec == "self":
        dmod, dkw = module, {"exit_layer": exit_layer}
    else:
        dmod, dkw = draft_module, {}

    @torch.inference_mode()
    def run(prompt_ids, rng: Union[None, int, torch.Generator] = None
            ) -> SpecGenerateResult:
        if temperature > 0.0 and rng is None:
            raise GenerationInputError(
                "temperature > 0 requires an explicit rng (an int seed or a "
                "torch.Generator)")
        dev = module.device
        prompt = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
        B, Lp = prompt.shape
        if Lp + max_new_tokens - 1 > cap:
            raise GenerationInputError(
                f"prompt ({Lp}) + max_new_tokens ({max_new_tokens}) - 1 "
                f"exceeds the model's max_len ({cap})")
        dcap = (getattr(draft_module, "max_len", None)
                if spec == "draft" else cap)
        if dcap is not None and Lp + max_new_tokens - 1 > dcap:
            raise GenerationInputError(
                f"draft model's max_len ({dcap}) cannot cover the request")
        total = min(Lp + max_new_tokens - 1 + k, int(cap))
        tp = -(-total // pt)
        npages = B * tp + 1  # page 0 is the trash page
        table = (1 + torch.arange(B, device=dev)[:, None] * tp
                 + torch.arange(tp, device=dev)[None, :]).to(torch.int32)
        cache = init_paged_cache(module, npages, pt, kv_quant, paged_attn)
        dcache = (init_paged_cache(draft_module, npages, pt, kv_quant,
                                   paged_attn)
                  if spec == "draft" else cache)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        plens = torch.full((B,), Lp, dtype=torch.int32, device=dev)
        logits = module(prompt, decode=True, positions=zeros, pages=table,
                        seq_lens=plens, cache=cache)[:, -1]
        if spec == "draft":
            draft_module(prompt, decode=True, return_hidden=True,
                         positions=zeros, pages=table, seq_lens=plens,
                         cache=dcache)
        temps = torch.full((B,), float(temperature), device=dev)
        topks = torch.full((B,), int(top_k or 0), dtype=torch.int64,
                           device=dev)
        eoss = torch.full((B,), -1 if eos_id is None else int(eos_id),
                          dtype=torch.int64, device=dev)
        topk_cap = max(SPEC_TOP_K_CAP, int(top_k or 0))
        gens: List[Optional[torch.Generator]] = [None] * B
        if temperature > 0.0:
            seed = seed_of(rng)
            gens = [make_generator(fold_in(seed, b), dev) for b in range(B)]
        sampled = temperature > 0.0
        tok = draft_sample(logits, temps, topks, gens, topk_cap,
                           with_probs=False)[0]
        live = torch.full((B,), max_new_tokens > 1, device=dev)
        if eos_id is not None:
            live = live & (tok != eos_id)
        rem = torch.full((B,), max_new_tokens - 1, dtype=torch.int64,
                         device=dev)
        pos = plens.long()
        outs = [[t] for t in tok.tolist()]
        proposed = accepted = drafted = steps = 0
        n_live = int(live.sum())
        while n_live and steps < max_new_tokens:
            drafts = torch.empty((B, k), dtype=torch.int64, device=dev)
            q = (torch.empty((B, k, module.vocab_size), device=dev)
                 if sampled else None)
            d_tok, d_pos = tok, pos
            for i in range(k):
                lg = dmod(d_tok[:, None], decode=True,
                          positions=d_pos.to(torch.int32), pages=table,
                          seq_lens=live.int(), cache=dcache, **dkw)[:, -1]
                d_tok, probs = draft_sample(lg, temps, topks, gens, topk_cap,
                                            with_probs=sampled)
                if q is not None:
                    q[:, i] = probs
                drafts[:, i] = d_tok
                d_pos = d_pos + 1
            if spec == "draft":
                # write-only: the k-th draft's K/V, or a fully accepted
                # step leaves a gap in the drafter's arena
                dmod(d_tok[:, None], decode=True, return_hidden=True,
                     positions=d_pos.to(torch.int32), pages=table,
                     seq_lens=live.int(), cache=dcache)
            vlg = module(torch.cat([tok[:, None], drafts], dim=1),
                         decode=True, positions=pos.to(torch.int32),
                         pages=table, seq_lens=live.int() * (k + 1),
                         cache=cache)
            emit, n_acc = spec_accept(vlg, drafts, q, temps, topks, gens,
                                      topk_cap)
            out, n_take, live2, rem, tok = spec_mask_emissions(
                emit, n_acc, live, rem, eoss, tok)
            pos = torch.where(live, pos + n_take, pos)
            # the step's one device->host copy
            packed = torch.cat([out, torch.where(live, n_acc, 0)[:, None],
                                live2[:, None].long()], dim=1).cpu()
            for b in range(B):
                outs[b].extend(t for t in packed[b, :k + 1].tolist()
                               if t >= 0)
            drafted += k * n_live
            accepted += int(packed[:, k + 1].sum())
            proposed += (k + 1) * n_live
            steps += 1
            live = live2
            n_live = int(packed[:, k + 2].sum())
        lengths = torch.tensor([len(o) for o in outs], dtype=torch.int64,
                               device=dev)
        tokens = torch.tensor(
            [o + [PAD_ID] * (max_new_tokens - len(o)) for o in outs],
            dtype=torch.int64, device=dev)
        return SpecGenerateResult(tokens, lengths, proposed, accepted,
                                  drafted, steps)

    return run


def generate(module, prompt_ids, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             eos_id: Optional[int] = None,
             rng: Union[None, int, torch.Generator] = None,
             spec: str = "", spec_k: int = 4, draft_module=None,
             spec_exit_layer: Optional[int] = None) -> GenerateResult:
    """Sample ``max_new_tokens`` continuations of dense ``prompt_ids``
    ``[B, Lp]`` (JAX :629). Greedy when ``temperature == 0``;
    ``temperature > 0`` requires ``rng`` (an int seed or a
    ``torch.Generator``): a silent default would return the same draw on
    every call. ``top_k`` truncates before the draw. ``prompt_len +
    max_new_tokens - 1`` must fit ``module.max_len``.

    ``spec`` ("self" | "draft") routes through
    :func:`make_speculative_generate_fn` with ``spec_k``,
    ``spec_exit_layer`` and ``draft_module`` (which carries its own
    weights, so there is no ``draft_variables``); greedy tokens equal the
    spec-off path's."""
    if temperature > 0.0 and rng is None:
        raise GenerationInputError(
            "temperature > 0 requires an explicit rng (an int seed or a "
            "torch.Generator) - otherwise every call returns the same draw")
    if temperature <= 0.0:
        top_k = None  # greedy ignores top_k
    if spec:
        out = make_speculative_generate_fn(
            module, max_new_tokens=max_new_tokens, spec=spec, spec_k=spec_k,
            draft_module=draft_module, exit_layer=spec_exit_layer,
            temperature=temperature, top_k=top_k,
            eos_id=eos_id)(prompt_ids, rng)
        return GenerateResult(out.tokens, out.lengths)
    dev = module.device
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64,
                             device=dev)
    gen = None
    if temperature > 0.0:
        gen = (rng if isinstance(rng, torch.Generator)
               else make_generator(seed_of(rng), dev))
    return make_generate_fn(module, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_id=eos_id)(prompt, gen)


def _takes_decode(module) -> bool:
    try:
        return "decode" in inspect.signature(module.forward).parameters
    except (TypeError, ValueError):
        return False


def generate_from_request(module, req) -> dict:
    """Serve an ``api.types.GenerateRequest`` in one shot (JAX :714): the
    wire entry of a live job's ``/generate`` and of serving without the
    batching engine. Returns ``{"tokens": [[...]], "lengths": [...]}``;
    user-shape problems (no decode path, bad prompt shapes, capacity
    overflow) are KubeMLError 400. A ragged batch (``prompt_lengths``)
    decodes each row at its true length, grouped by length."""
    from ..api.errors import KubeMLError

    prompts = np.asarray(req.prompts)
    if prompts.ndim != 2 or not np.issubdtype(prompts.dtype, np.integer):
        raise KubeMLError(
            "prompts must be a [batch, prompt_len] integer token array", 400)
    if not _takes_decode(module):
        raise KubeMLError(
            "model does not support KV-cache decode (generation needs a "
            "causal LM like CausalTransformer)", 400)
    lengths = req.prompt_lengths
    if lengths is not None and any(int(v) != prompts.shape[1]
                                   for v in lengths):
        return _generate_ragged(module, prompts, req)
    try:
        out = generate(module, prompts, max_new_tokens=req.max_new_tokens,
                       temperature=req.temperature, top_k=req.top_k,
                       eos_id=req.eos_id, rng=req.seed)
    except GenerationInputError as e:
        raise KubeMLError(str(e), 400)
    return {"tokens": out.tokens.tolist(), "lengths": out.lengths.tolist()}


def _generate_ragged(module, prompts: np.ndarray, req) -> dict:
    """One-shot serving of a ragged batch: rows grouped by true length, one
    ``generate`` a group (its seed ``fold_in(seed, plen)``), results put
    back in row order."""
    from ..api.errors import KubeMLError

    B = prompts.shape[0]
    by_len: Dict[int, List[int]] = {}
    for i, plen in enumerate(int(v) for v in req.prompt_lengths):
        by_len.setdefault(plen, []).append(i)
    tokens: list = [None] * B
    lengths: list = [None] * B
    try:
        for plen, rows in sorted(by_len.items()):
            rng = (fold_in(req.seed, plen) if req.seed is not None
                   else None)
            out = generate(module, prompts[rows, :plen],
                           max_new_tokens=req.max_new_tokens,
                           temperature=req.temperature, top_k=req.top_k,
                           eos_id=req.eos_id, rng=rng)
            for j, row in enumerate(rows):
                tokens[row] = out.tokens[j].tolist()
                lengths[row] = int(out.lengths[j])
    except GenerationInputError as e:
        raise KubeMLError(str(e), 400)
    return {"tokens": tokens, "lengths": lengths}


class PagedCache:
    """The per-layer K/V page arenas of one paged decoder.

    ``layers[i]`` holds ``k_pages``/``v_pages`` ``[kv_pages, page_tokens,
    H, D]`` (the compute dtype, or int8 with ``k_scale``/``v_scale``
    ``[kv_pages, H]`` f32 per-page-per-head absmax scales) - the JAX arena
    layout, byte for byte. ``paged_attn`` is the resolved read path
    (``cuda`` kernel or ``gather`` plain version) and ``kv_quant`` the
    resolved storage mode."""

    def __init__(self, layers: List[Dict[str, torch.Tensor]],
                 page_tokens: int, kv_quant: str, paged_attn: str):
        self.layers = layers
        self.page_tokens = page_tokens
        self.kv_quant = kv_quant
        self.paged_attn = paged_attn

    def zero_(self) -> "PagedCache":
        for arena in self.layers:
            for t in arena.values():
                t.zero_()
        return self


def init_paged_cache(module, kv_pages: int, page_tokens: int,
                     kv_quant: str = "off", paged_attn: str = "auto"
                     ) -> PagedCache:
    """Zeroed paged arenas for every layer of ``module``, on the module's
    device. The JAX function sizes the arena from clone fields on the
    module; here the geometry is passed and carried by the cache."""
    kvq = resolve_kv_quant(kv_quant)
    dev = module.device
    H = module.num_heads
    D = module.embed_dim // H
    store = torch.int8 if kvq == "int8" else module.dtype
    layers = []
    for _ in range(module.depth):
        arena = {name: torch.zeros((kv_pages, page_tokens, H, D), dtype=store,
                                   device=dev)
                 for name in ("k_pages", "v_pages")}
        if kvq == "int8":
            arena.update({name: torch.zeros((kv_pages, H),
                                            dtype=torch.float32, device=dev)
                          for name in ("k_scale", "v_scale")})
        layers.append(arena)
    return PagedCache(layers, page_tokens, kvq,
                      resolve_paged_attn(paged_attn, dev))


def supports_paged_decode(module) -> bool:
    """Whether ``module`` can serve through the paged engine: its forward
    takes ``positions``/``pages``/``seq_lens``/``cache`` and it does not
    interleave MoE blocks."""
    if getattr(module, "moe_every", 0):
        return False
    try:
        params = inspect.signature(module.forward).parameters
    except (TypeError, ValueError):
        return False
    return all(p in params for p in ("positions", "pages", "seq_lens",
                                     "cache"))


def _masked_scaled(logits, temp, topk, topk_cap: int = SPEC_TOP_K_CAP):
    """Per-row knob-adjusted logits: temperature scaling + top-k truncation
    with RUNTIME knobs. logits ``[S, V]`` f32, temp ``[S]`` (rows <= 0 give
    junk the greedy branch discards), topk ``[S]`` int (0 = off)."""
    V = logits.shape[-1]
    scaled = logits / temp.clamp_min(1e-6)[:, None]
    kwide = min(topk_cap, V)
    vals = torch.topk(scaled, kwide, dim=-1).values  # sorted desc
    kth = torch.gather(vals, 1, (topk.long() - 1).clamp(0, kwide - 1)[:, None])
    return torch.where((topk > 0)[:, None] & (scaled < kth),
                       torch.finfo(torch.float32).min, scaled)


def _knob_probs(logits, temp, topk, topk_cap: int = SPEC_TOP_K_CAP):
    """The per-row sampling distribution under runtime knobs: softmax over
    the temperature-scaled, top-k-truncated logits - the p (target) and q
    (drafter) the acceptance rule compares."""
    return torch.softmax(_masked_scaled(logits, temp, topk, topk_cap), dim=-1)


def _hot(gens: Sequence[Optional[torch.Generator]]) -> List[int]:
    return [i for i, g in enumerate(gens) if g is not None]


def draft_sample(logits, temp, topk, gens, topk_cap: int = SPEC_TOP_K_CAP,
                 with_probs: bool = True):
    """One draw per row with runtime knobs: greedy rows (``gens[i]`` None)
    take the argmax, sampled rows draw one token from their generator.
    Returns ``(tokens [S], probs [S, V])``: probs is the knob-adjusted
    distribution (the drafter's q, which the acceptance test of sampled
    rows reads); ``with_probs=False`` computes it for the sampled rows
    only and returns None in its place."""
    toks = torch.argmax(logits, dim=-1)
    hot = _hot(gens)
    probs = _knob_probs(logits, temp, topk, topk_cap) if with_probs else None
    if hot:
        idx = torch.tensor(hot, device=logits.device)
        hp = (probs[idx] if probs is not None
              else _knob_probs(logits[idx], temp[idx], topk[idx], topk_cap))
        toks[idx] = torch.cat([torch.multinomial(hp[j], 1, generator=gens[i])
                               for j, i in enumerate(hot)])
    return toks, probs


def spec_accept(tgt_logits, draft_tokens, draft_probs, temp, topk, gens,
                topk_cap: int = SPEC_TOP_K_CAP):
    """The distribution-preserving acceptance rule, per row.

    ``tgt_logits [S, k+1, V]`` f32 - the verify forward's logits (position
    i is the distribution after feeding draft i-1; position 0 follows the
    row's current token); ``draft_tokens [S, k]``; ``draft_probs [S, k,
    V]`` (the drafter's q; None when no row samples); ``temp``, ``topk``
    ``[S]``; ``gens`` a generator per sampled row, None per greedy row.

    Greedy rows: draft i is accepted iff it is the target argmax at
    position i, and the correction is the target argmax at the first
    mismatch - the emitted stream is the plain argmax chain. Sampled rows
    draw k uniforms, then one correction token, from their generator:
    accept draft d_i while u_i * q_i(d_i) < p_i(d_i); at the first
    rejection draw from the normalized residual max(p - q, 0); if all k
    drafts survive, the bonus token draws from p_k. Returns ``(emit [S,
    k+1]`` - accepted drafts, then the correction or bonus, -1 past it;
    ``n_acc [S]`` - accepted drafts in [0, k])."""
    S, k1, V = tgt_logits.shape
    k = k1 - 1
    dev = tgt_logits.device
    tgt_arg = torch.argmax(tgt_logits, dim=-1)  # [S, k+1]
    drafts = draft_tokens.long()
    acc = tgt_arg[:, :k] == drafts  # the greedy rule; sampled rows below
    hot = _hot(gens)
    if hot:
        idx = torch.tensor(hot, device=dev)
        n = len(hot)
        p = _knob_probs(tgt_logits[idx].reshape(n * k1, V),
                        temp[idx].repeat_interleave(k1),
                        topk[idx].repeat_interleave(k1),
                        topk_cap).reshape(n, k1, V)
        if k > 0:
            q = draft_probs[idx]
            d = drafts[idx][..., None]
            p_d = p[:, :k].gather(-1, d)[..., 0]
            q_d = q.gather(-1, d)[..., 0]
            u = torch.stack([torch.rand(k, generator=gens[i], device=dev)
                             for i in hot])
            # u < min(1, p/q)  <=>  u * q < p  (u < 1: p >= q accepts)
            acc[idx] = u * q_d < p_d
    # leading-run length: drafts past the first rejection never count
    n_acc = (acc.long().cumprod(dim=1).sum(dim=1) if k > 0
             else torch.zeros(S, dtype=torch.long, device=dev))
    correction = tgt_arg.gather(1, n_acc[:, None])[:, 0]
    if hot:
        nh = n_acc[idx]
        rows = torch.arange(n, device=dev)
        p_j = p[rows, nh]  # [n, V]
        if k > 0:
            q_j = q[rows, nh.clamp(max=k - 1)]
            resid = (p_j - q_j).clamp_min(0.0)
            rs = resid.sum(-1, keepdim=True)
            # an empty residual at a rejection means p ~= q: the acceptance
            # probability was ~1, so sampling p is the limit
            resid = torch.where(rs > 1e-9, resid / rs.clamp_min(1e-30), p_j)
            corr = torch.where((nh < k)[:, None], resid, p_j)
        else:
            corr = p_j
        correction[idx] = torch.cat([
            torch.multinomial(corr[j], 1, generator=gens[i])
            for j, i in enumerate(hot)])
    pos = torch.arange(k1, device=dev)[None, :]
    drafts_wide = torch.cat(
        [drafts, drafts.new_zeros((S, 1))], dim=1)
    emit = torch.where(pos < n_acc[:, None], drafts_wide,
                       torch.full_like(drafts_wide, -1))
    emit = torch.where(pos == n_acc[:, None], correction[:, None], emit)
    return emit, n_acc


def spec_mask_emissions(emit, n_acc, live, remaining, eos, tok):
    """Clip one spec step's emissions to what each row may emit: only live
    rows emit, at most ``remaining`` tokens, and nothing after the first
    ``eos`` (the eos itself counts). Returns ``(out [S, k+1]`` with -1 past
    the clip, ``n_take [S]``, ``live2 [S]``, ``rem2 [S]``, ``feed [S]`` -
    the next token to feed, frozen for dead rows)."""
    S, k1 = emit.shape
    idx = torch.arange(k1, device=emit.device)[None, :]
    valid = ((idx <= n_acc[:, None]) & (idx < remaining[:, None])
             & live[:, None])
    is_eos = (eos >= 0)[:, None] & (emit == eos[:, None]) & valid
    eos_before = is_eos.long().cumsum(dim=1) - is_eos.long()
    valid = valid & (eos_before == 0)
    n_take = valid.sum(dim=1)
    out = torch.where(valid, emit, torch.full_like(emit, -1))
    hit_eos = (is_eos & valid).any(dim=1)
    rem2 = remaining - n_take
    live2 = live & ~hit_eos & (rem2 > 0)
    last = out.gather(1, (n_take - 1).clamp(0, k1 - 1)[:, None])[:, 0]
    feed = torch.where(live & (n_take > 0), last, tok)
    return out, n_take, live2, rem2, feed
