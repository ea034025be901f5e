"""Text -> token LM data: tokenize a corpus and pack it to ``[N, L]`` rows,
the port's copy of ``kubeml_tpu/data/text.py``.

A corpus (documents separated by blank lines) becomes an int32 ``[N, L]``
token array with EOS after each document, uploaded through the storage
service's ``corpus`` form (``kubeml dataset create-text``).

The byte tokenizer needs no download: PAD 0, EOS 1, byte b -> b + 2, vocab
258; any model with ``vocab_size >= 258`` trains on it and its generations
decode back to text. A user vocabulary (``{"tokens": {str: id}}``, greedy
longest match) or a BPE trained on the corpus (``data.bpe``) can take its
place; the dataset's packing record names the tokenizer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.errors import KubeMLError

PAD_ID = 0  # models.gpt.PAD_ID, kept here so that the text path needs no torch

EOS_ID = 1
BYTE_OFFSET = 2  # byte b -> token b + 2 (0 = pad, 1 = eos)
BYTE_VOCAB = 256 + BYTE_OFFSET


def byte_encode(text: str) -> np.ndarray:
    """UTF-8 bytes shifted past the specials; int32 [len]."""
    raw = np.frombuffer(text.encode("utf-8"), np.uint8)
    return raw.astype(np.int32) + BYTE_OFFSET


def byte_decode(tokens: Sequence[int]) -> str:
    """Inverse of :func:`byte_encode`; PAD/EOS stop the row (generation
    rows pad after EOS by contract)."""
    out = bytearray()
    for t in tokens:
        t = int(t)
        if t in (PAD_ID, EOS_ID):
            break
        if t >= BYTE_OFFSET and t < BYTE_VOCAB:
            out.append(t - BYTE_OFFSET)
    return out.decode("utf-8", errors="replace")


class VocabTokenizer:
    """Greedy longest-match tokenizer over a user-supplied vocab asset:
    ``{"tokens": {"the": 5, "cat": 6, ...}}`` (ids >= 2; 0/1 reserved).
    Bytes not covered by any vocab entry fall back to byte tokens IF the
    vocab leaves room below ``byte_fallback_base``; otherwise unknown input
    is a 400 (the user owns their vocabulary)."""

    def __init__(self, spec: Dict):
        tokens = spec.get("tokens")
        if not isinstance(tokens, dict) or not tokens:
            raise KubeMLError(
                "tokenizer asset must carry a non-empty {'tokens': {str: id}}", 400)
        self.vocab: Dict[str, int] = {}
        for tok, tid in tokens.items():
            if not isinstance(tok, str) or isinstance(tid, bool) or not isinstance(tid, int):
                raise KubeMLError("tokenizer tokens must map str -> int", 400)
            if tid < BYTE_OFFSET:
                raise KubeMLError(
                    f"token id {tid} is reserved (0 = pad, 1 = eos)", 400)
            self.vocab[tok] = tid
        self.max_len = max(len(t) for t in self.vocab)
        self.vocab_size = max(self.vocab.values()) + 1
        self._by_id = {tid: tok for tok, tid in self.vocab.items()}

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        i = 0
        n = len(text)
        while i < n:
            for width in range(min(self.max_len, n - i), 0, -1):
                tid = self.vocab.get(text[i:i + width])
                if tid is not None:
                    ids.append(tid)
                    i += width
                    break
            else:
                raise KubeMLError(
                    f"tokenizer cannot encode {text[i:i+8]!r} at offset {i} "
                    f"(no vocab entry covers it)", 400)
        return np.asarray(ids, np.int32)

    def decode_bytes(self, token: int):
        """UTF-8 bytes of one id (None for PAD/EOS/unknown) — the same
        streaming-decode contract as bpe.BPETokenizer."""
        tok = self._by_id.get(int(token))
        return tok.encode("utf-8") if tok is not None else None

    def decode(self, tokens: Sequence[int]) -> str:
        out = []
        for t in tokens:
            t = int(t)
            if t in (PAD_ID, EOS_ID):
                break
            tok = self._by_id.get(t)
            if tok is not None:
                out.append(tok)
        return "".join(out)


def split_documents(corpus: str) -> List[str]:
    """Blank-line-separated document blocks (the plain-text corpus form)."""
    docs = [d.strip() for d in corpus.split("\n\n")]
    return [d for d in docs if d]


def pack_corpus(corpus: str, seq_len: int,
                tokenizer_spec: Optional[Dict] = None) -> Tuple[np.ndarray, Dict]:
    """Tokenize + pack a corpus into ``[N, seq_len]`` int32 rows.

    Documents are joined into one stream with EOS after each, then cut into
    fixed rows (the standard LM packing — no padding inside the stream, the
    remainder tail is dropped). Returns (rows, meta) where meta records the
    tokenizer, vocab size, and token counts for the dataset manifest."""
    if seq_len < 2:
        raise KubeMLError("seq_len must be >= 2", 400)
    docs = split_documents(corpus)
    if not docs:
        raise KubeMLError("corpus has no documents (blank-line separated)", 400)
    if tokenizer_spec is not None:
        if tokenizer_spec.get("kind") == "bpe":
            from .bpe import BPETokenizer

            tok = BPETokenizer(tokenizer_spec)
            kind = "bpe"
        else:
            tok = VocabTokenizer(tokenizer_spec)
            kind = "vocab-json"
        encode = tok.encode
        vocab_size = tok.vocab_size
    else:
        encode = byte_encode
        vocab_size = BYTE_VOCAB
        kind = "byte"
    pieces = []
    for d in docs:
        pieces.append(encode(d))
        pieces.append(np.asarray([EOS_ID], np.int32))
    stream = np.concatenate(pieces)
    n_rows = len(stream) // seq_len
    if n_rows == 0:
        raise KubeMLError(
            f"corpus tokenizes to {len(stream)} tokens — fewer than one "
            f"row of seq_len {seq_len}", 400)
    rows = stream[: n_rows * seq_len].reshape(n_rows, seq_len)
    meta = {
        "tokenizer": kind,
        "vocab_size": int(vocab_size),
        "eos_id": EOS_ID,
        "seq_len": int(seq_len),
        "documents": len(docs),
        "tokens": int(len(stream)),
        "rows": int(n_rows),
    }
    return rows, meta
