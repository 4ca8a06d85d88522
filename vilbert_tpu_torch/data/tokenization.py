"""Tokenizers.

The port's own copy of ``vilbert_tpu/data/tokenization.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

The reference uses pytorch_transformers' BertTokenizer (task_utils.py:396,
train_concap.py:306). Here:

- ``WordPieceTokenizer``: HF ``tokenizers`` (Rust) WordPiece over a local
  vocab.txt — same algorithm/vocab as bert-base-uncased, no network needed.
- ``HashTokenizer``: dependency-free deterministic tokenizer for tests and
  synthetic pipelines.

Both expose the minimal interface the pipelines need: ``encode`` (no special
tokens), special-token ids, and single/pair special-token assembly
(reference add_special_tokens_single_sentence,
concept_cap_dataset.py:550 / vcr_dataset.py sentence pairs).
"""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    vocab_size: int
    pad_token_id: int
    cls_token_id: int
    sep_token_id: int
    mask_token_id: int

    def encode(self, text: str) -> List[int]: ...


def add_special_single(tok: "Tokenizer", ids: List[int]) -> List[int]:
    return [tok.cls_token_id] + list(ids) + [tok.sep_token_id]


def add_special_pair(tok: "Tokenizer", a: List[int], b: List[int]) -> List[int]:
    return [tok.cls_token_id] + list(a) + [tok.sep_token_id] + list(b) + [tok.sep_token_id]


class WordPieceTokenizer:
    """BERT WordPiece over a local vocab file (tokenizers backend)."""

    def __init__(self, vocab_file: str, lowercase: bool = True):
        from tokenizers import BertWordPieceTokenizer

        self._tok = BertWordPieceTokenizer(vocab_file, lowercase=lowercase)
        self.vocab_size = self._tok.get_vocab_size()
        vocab = self._tok.get_vocab()
        self.pad_token_id = vocab["[PAD]"]
        self.cls_token_id = vocab["[CLS]"]
        self.sep_token_id = vocab["[SEP]"]
        self.mask_token_id = vocab["[MASK]"]

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)

    def __len__(self) -> int:
        return self.vocab_size


class HashTokenizer:
    """Deterministic hash tokenizer for tests/synthetic data.

    ids: 0=[PAD], 1=[CLS], 2=[SEP], 3=[MASK], 4=[UNK], 5.. hashed words.
    """

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.cls_token_id = 1
        self.sep_token_id = 2
        self.mask_token_id = 3
        self.unk_token_id = 4

    def encode(self, text: str) -> List[int]:
        out = []
        for word in text.lower().split():
            h = 0
            for ch in word:
                h = (h * 131 + ord(ch)) % (self.vocab_size - 5)
            out.append(5 + h)
        return out

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)

    def __len__(self) -> int:
        return self.vocab_size


def load_tokenizer(vocab_file: Optional[str] = None, vocab_size: int = 30522):
    if vocab_file:
        return WordPieceTokenizer(vocab_file)
    return HashTokenizer(vocab_size)
