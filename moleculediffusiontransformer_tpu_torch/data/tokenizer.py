"""Character-level SMILES tokenizer, keras-index-compatible (the port's own
copy of the JAX package's `data/tokenizer.py`, numpy only).

The reference tokenizes SMILES with ``tensorflow.keras`` ``Tokenizer(
char_level=True, filters='', lower=False)`` (`generative.py:16-17` and
Inverse_Diffusion.ipynb cell 36).  Keras assigns indices by descending
character frequency, ties broken by first-seen order, starting at 1 (0 is
reserved for padding).  This module reproduces that index assignment exactly
so published checkpoints and metrics remain comparable, without the
tensorflow dependency.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class CharTokenizer:
    """Keras-compatible char-level tokenizer (frequency-ordered vocabulary)."""

    def __init__(self):
        self.word_counts: "OrderedDict[str, int]" = OrderedDict()
        self.word_index: Dict[str, int] = {}
        self.index_word: Dict[int, str] = {}

    def fit_on_texts(self, texts: Iterable[str]) -> "CharTokenizer":
        for text in texts:
            for ch in text:
                if ch in self.word_counts:
                    self.word_counts[ch] += 1
                else:
                    self.word_counts[ch] = 1
        # Keras: sorted by count desc; Python's sort is stable, so ties keep
        # first-occurrence (insertion) order.
        ordered = sorted(self.word_counts.items(), key=lambda kv: kv[1],
                         reverse=True)
        self.word_index = {ch: i + 1 for i, (ch, _) in enumerate(ordered)}
        self.index_word = {i: ch for ch, i in self.word_index.items()}
        return self

    @property
    def vocab_size(self) -> int:
        """Number of distinct characters (excludes the 0 padding id)."""
        return len(self.word_index)

    @property
    def num_tokens(self) -> int:
        """Vocabulary size including the padding id — the reference's
        ``num_words`` (21 chars -> 22)."""
        return len(self.word_index) + 1

    def texts_to_sequences(self, texts: Sequence[str]) -> List[List[int]]:
        out = []
        for text in texts:
            out.append([self.word_index[ch] for ch in text
                        if ch in self.word_index])
        return out

    def sequences_to_texts(self, sequences) -> List[str]:
        """Keras joins known tokens with spaces and drops id 0 / unknown ids."""
        out = []
        for seq in sequences:
            chars = [self.index_word[int(i)] for i in seq
                     if int(i) in self.index_word]
            out.append(" ".join(chars))
        return out

    def decode(self, sequences) -> List[str]:
        """Reference ``reverse_tokenize`` (`generative.py:1069-1078`): decode
        then strip the keras-inserted spaces."""
        return [t.replace(" ", "") for t in self.sequences_to_texts(sequences)]

    def state_dict(self) -> Dict:
        return {"word_counts": dict(self.word_counts),
                "word_index": dict(self.word_index)}

    @classmethod
    def from_state_dict(cls, state: Dict) -> "CharTokenizer":
        tok = cls()
        tok.word_counts = OrderedDict(state["word_counts"])
        tok.word_index = {k: int(v) for k, v in state["word_index"].items()}
        tok.index_word = {v: k for k, v in tok.word_index.items()}
        return tok


def pad_sequences(sequences: Sequence[Sequence[int]], maxlen: int,
                  padding: str = "post", truncating: str = "post",
                  value: int = 0, dtype=np.int32) -> np.ndarray:
    """Keras-semantics pad/truncate (reference pads post/post throughout)."""
    n = len(sequences)
    out = np.full((n, maxlen), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if len(seq) > maxlen:
            seq = seq[:maxlen] if truncating == "post" else seq[-maxlen:]
        if padding == "post":
            out[i, :len(seq)] = seq
        else:
            out[i, maxlen - len(seq):] = seq
    return out


def add_start_end_char(texts: Sequence[str], start_char: str = "@",
                       end_char: str = "$") -> List[str]:
    """Reference `generative.py:1537-1545`."""
    return [start_char + t + end_char for t in texts]


def remove_start_end_token(s: str, start: str = "@", end: str = "$") -> str:
    return s.replace(start, "").replace(end, "")


def remove_start_end_token_first(s: str, start: str = "@", end: str = "$") -> str:
    """Reference `generative.py:1552-1559`: take the span between the first
    start char and the first end char."""
    i = s.find(start)
    j = s.find(end)
    if j < 0:
        return s[i + 1:]
    return s[i + 1:j]


def one_hot_signed(ids: np.ndarray, num_classes: int) -> np.ndarray:
    """One-hot with zeros remapped to -1 (reference
    ``encode_SMILES_into_one_hot``, `generative.py:1563-1572`)."""
    eye = np.full((num_classes, num_classes), -1.0, dtype=np.float32)
    np.fill_diagonal(eye, 1.0)
    return eye[np.asarray(ids, dtype=np.int64)]


def encode_smiles_one_hot(tokenizer: CharTokenizer, smiles: Sequence[str],
                          max_length: int = 64,
                          num_classes: int = 16) -> np.ndarray:
    """tokenize -> pad(post/post) -> one-hot(0 -> -1); returns (b, L, C)."""
    ids = pad_sequences(tokenizer.texts_to_sequences(smiles), max_length)
    return one_hot_signed(ids, num_classes)
