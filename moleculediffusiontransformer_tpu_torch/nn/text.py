"""Text conditioning: a lazy HuggingFace T5 encoder (port of `nn/text.py`;
reference `T5Embedder`, `modules.py:1329-1359`).

It tokenizes text and returns the frozen encoder's hidden states as the
(b, max_length, hidden) embedding a CFG UNet cross-attends to.  Nothing is
imported or loaded at construction: ``transformers`` is imported, and the
weights (a download) are loaded, on the first call.  The encoder runs on
``device``, the card unless the caller names another, and the embedding is
returned there.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch


class T5Embedder:
    """Frozen T5 text encoder -> (b, max_length, hidden) embeddings."""

    def __init__(self, model: str = "t5-base", max_length: int = 64,
                 device: Optional[Union[str, torch.device]] = None):
        self.model_name = model
        self.max_length = max_length
        self.device = torch.device("cuda" if device is None else device)
        self._tokenizer = None
        self._transformer = None

    def _load(self) -> None:
        if self._transformer is None:
            from transformers import AutoTokenizer, T5EncoderModel
            self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
            self._transformer = T5EncoderModel.from_pretrained(
                self.model_name).to(self.device).eval()

    @torch.no_grad()
    def __call__(self, texts: List[str]) -> torch.Tensor:
        self._load()
        encoded = self._tokenizer(texts, truncation=True,
                                  max_length=self.max_length,
                                  padding="max_length", return_tensors="pt")
        return self._transformer(
            input_ids=encoded["input_ids"].to(self.device),
            attention_mask=encoded["attention_mask"].to(self.device)
        )["last_hidden_state"]
