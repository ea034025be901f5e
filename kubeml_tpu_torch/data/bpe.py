"""Byte-level BPE trained at dataset-create time, with no download: the
port's copy of ``kubeml_tpu/data/bpe.py``.

``kubeml dataset create-text --train-bpe N`` trains a merge table on the
uploaded corpus inside the storage service and stores it as the dataset's
tokenizer asset, so training, generation and the CLI's text loop share one
vocabulary. The id space extends the byte fallback of ``data.text``:

    PAD = 0, EOS = 1, byte b -> b + 2 (ids 2..257), merge i -> 258 + i

Training is the incremental algorithm: split the text into whitespace-
bounded chunks (no merge crosses a word boundary), count the distinct
chunks, then merge the most frequent adjacent pair again and again,
updating only the chunks that hold it. A lazy max-heap finds the pair; a
tie on the count goes to the smaller pair, so a corpus and a vocabulary
size give one merge table, equal to the JAX package's.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.errors import KubeMLError
from .text import BYTE_OFFSET, BYTE_VOCAB, EOS_ID, PAD_ID

# whitespace runs are their own chunks: merges may learn "  "/"\n\n" units
# but never a piece that straddles a word boundary
_CHUNKS = re.compile(r"\S+|\s+")

MERGE_BASE = BYTE_VOCAB  # first merge id (258)


def _chunk_ids(chunk: str) -> Tuple[int, ...]:
    return tuple(b + BYTE_OFFSET for b in chunk.encode("utf-8"))


def _merge_word(w: Sequence[int], pair: Tuple[int, int],
                new_id: int) -> List[int]:
    """Replace every (non-overlapping, left-to-right) occurrence of ``pair``
    in ``w`` with ``new_id`` — the ONE substitution rule the trainer and
    encoder must share (their equivalence is what makes encoded ids match
    the trained distribution)."""
    merged: List[int] = []
    i = 0
    while i < len(w):
        if i + 1 < len(w) and (w[i], w[i + 1]) == pair:
            merged.append(new_id)
            i += 2
        else:
            merged.append(w[i])
            i += 1
    return merged


def train_bpe(corpus: str, vocab_size: int) -> Dict:
    """Learn a merge table from ``corpus``; returns the tokenizer asset
    ``{"kind": "bpe", "vocab_size": V, "merges": [[a, b], ...]}``.

    ``vocab_size`` bounds the FINAL id space (base 258 + merges); training
    stops early when no adjacent pair repeats. Deterministic: ties on count
    break toward the smaller pair."""
    if vocab_size <= MERGE_BASE:
        raise KubeMLError(
            f"train-bpe vocab_size must exceed the byte base {MERGE_BASE}", 400)
    chunk_freq = Counter(_CHUNKS.findall(corpus))
    if not chunk_freq:
        raise KubeMLError("corpus is empty — nothing to train a BPE on", 400)
    words: List[List[int]] = []
    freqs: List[int] = []
    for chunk, f in chunk_freq.items():
        words.append(list(_chunk_ids(chunk)))
        freqs.append(f)

    import heapq

    pair_counts: Counter = Counter()
    pair_words: Dict[Tuple[int, int], set] = {}
    for wi, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pair_counts[pair] += freqs[wi]
            pair_words.setdefault(pair, set()).add(wi)

    # lazy-invalidation max-heap over (-count, pair): a full scan of the
    # live pair table per merge is O(pairs x merges) — minutes for a real
    # corpus at 16k merges. Entries go stale when counts change; the pop
    # loop discards any entry whose count no longer matches the table.
    # Tuple order gives the same deterministic tie-break as the scan
    # (highest count, then smallest pair).
    heap = [(-c, p) for p, c in pair_counts.items()]
    heapq.heapify(heap)

    def touch(pair):
        c = pair_counts.get(pair)
        if c:
            heapq.heappush(heap, (-c, pair))

    merges: List[Tuple[int, int]] = []
    next_id = MERGE_BASE
    while next_id < vocab_size and heap:
        neg, best = heapq.heappop(heap)
        current = pair_counts.get(best)
        if current is None or -neg != current:
            continue  # stale entry
        if current < 2:  # nothing repeats: the corpus is fully compressed
            break
        merges.append(best)
        new_id = next_id
        next_id += 1
        for wi in list(pair_words.get(best, ())):
            w = words[wi]
            f = freqs[wi]
            # remove this word's old pair contributions (decremented pairs
            # re-enter the heap at their new count — their old entries are
            # stale and would otherwise be their ONLY entries)
            for pair in zip(w, w[1:]):
                pair_counts[pair] -= f
                if pair_counts[pair] <= 0:
                    del pair_counts[pair]
                else:
                    touch(pair)
                ws = pair_words.get(pair)
                if ws is not None:
                    ws.discard(wi)
                    if not ws:
                        del pair_words[pair]
            merged = _merge_word(w, best, new_id)
            words[wi] = merged
            # add the new contributions back
            for pair in zip(merged, merged[1:]):
                pair_counts[pair] += f
                pair_words.setdefault(pair, set()).add(wi)
                touch(pair)
    return {"kind": "bpe", "vocab_size": int(next_id),
            "merges": [[int(a), int(b)] for a, b in merges]}


class BPETokenizer:
    """Encoder/decoder over a trained merge table (the ``bpe`` asset)."""

    def __init__(self, spec: Dict):
        merges = spec.get("merges")
        if not isinstance(merges, list):
            raise KubeMLError("bpe asset must carry a 'merges' list", 400)
        self.ranks: Dict[Tuple[int, int], int] = {}
        self.ids: Dict[Tuple[int, int], int] = {}
        expand: Dict[int, bytes] = {
            b + BYTE_OFFSET: bytes([b]) for b in range(256)}
        for rank, pair in enumerate(merges):
            if (not isinstance(pair, (list, tuple)) or len(pair) != 2
                    or not all(isinstance(v, int) for v in pair)):
                raise KubeMLError("bpe merges must be [id, id] pairs", 400)
            a, b = int(pair[0]), int(pair[1])
            nid = MERGE_BASE + rank
            if a not in expand or b not in expand:
                raise KubeMLError(
                    f"bpe merge {rank} references unknown ids ({a}, {b})", 400)
            self.ranks[(a, b)] = rank
            self.ids[(a, b)] = nid
            expand[nid] = expand[a] + expand[b]
        self._expand = expand
        self.vocab_size = MERGE_BASE + len(merges)
        self._cache: Dict[str, Tuple[int, ...]] = {}

    # --- encode ---

    def _bpe_chunk(self, chunk: str) -> Tuple[int, ...]:
        got = self._cache.get(chunk)
        if got is not None:
            return got
        w = list(_chunk_ids(chunk))
        while len(w) > 1:
            best_rank, best_i = None, -1
            for i in range(len(w) - 1):
                r = self.ranks.get((w[i], w[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            pair = (w[best_i], w[best_i + 1])
            # merge EVERY occurrence of this pair (same rank applies)
            w = _merge_word(w, pair, self.ids[pair])
        out = tuple(w)
        if len(self._cache) < 1 << 16:
            self._cache[chunk] = out
        return out

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        for chunk in _CHUNKS.findall(text):
            ids.extend(self._bpe_chunk(chunk))
        return np.asarray(ids, np.int32)

    # --- decode ---

    def decode_bytes(self, token: int) -> Optional[bytes]:
        """The byte expansion of one id (None for PAD/EOS/out-of-vocab —
        the streaming decoder skips those, matching byte_decode)."""
        return self._expand.get(int(token))

    def decode(self, tokens: Sequence[int]) -> str:
        out = bytearray()
        for t in tokens:
            t = int(t)
            if t in (PAD_ID, EOS_ID):
                break
            piece = self._expand.get(t)
            if piece is not None:
                out.extend(piece)
        return out.decode("utf-8", errors="replace")


def tokenizer_from_spec(spec: Optional[Dict]):
    """The dataset's tokenizer object from its asset spec: None -> byte
    fallback (data/text byte_encode/byte_decode semantics, returned as
    None so callers keep their fast path), ``bpe`` -> BPETokenizer,
    legacy ``{"tokens": ...}`` -> VocabTokenizer."""
    if spec is None:
        return None
    if spec.get("kind") == "bpe":
        return BPETokenizer(spec)
    from .text import VocabTokenizer

    return VocabTokenizer(spec)
