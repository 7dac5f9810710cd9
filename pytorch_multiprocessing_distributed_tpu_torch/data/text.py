"""Byte-level text corpus: raw text files -> LM token streams.

The port's own copy of the JAX package's ``data/text.py``: every byte
is a token (ids 0..255) and id 256 separates documents, which is
``gpt_tiny``'s 257-token vocab. ``detokenize(tokenize(text)) == text``
for any UTF-8 input.
"""

from __future__ import annotations

import os
from typing import Iterable, Union

import numpy as np

#: document-separator token id (first id past the byte range)
DOC_SEP = 256
#: smallest vocab that fits byte tokens + the separator
BYTE_VOCAB = 257


def sniff_bytes(head: bytes) -> str:
    """``'npy'`` (np.save), ``'npz'`` (zip: np.savez) or ``'text'`` from
    a file's leading bytes — magic bytes, not the extension."""
    if head[:6] == b"\x93NUMPY":
        return "npy"
    if head[:4] == b"PK\x03\x04":
        return "npz"
    return "text"


def tokenize(text: Union[str, bytes]) -> np.ndarray:
    """Text (or raw bytes) -> int32 token ids in [0, 255]."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, dtype=np.uint8).astype(np.int32)


def detokenize(tokens: Iterable[int]) -> str:
    """Token ids -> text; ids outside the byte range become newlines."""
    arr = np.asarray(list(tokens) if not hasattr(tokens, "astype")
                     else tokens).astype(np.int64).ravel()
    arr = np.where((arr > 255) | (arr < 0), np.int64(ord("\n")), arr)
    return arr.astype(np.uint8).tobytes().decode("utf-8", errors="replace")


def load_text_corpus(path: str) -> np.ndarray:
    """A file — or a directory of files, in sorted order, joined by
    :data:`DOC_SEP` — as one int32 token stream. Numpy tooling output
    raises ``ValueError``."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if os.path.isfile(os.path.join(path, n)))
        if not names:
            raise FileNotFoundError(f"no files under corpus dir {path}")
        parts = []
        for i, name in enumerate(names):
            if i:
                parts.append(np.asarray([DOC_SEP], np.int32))
            with open(os.path.join(path, name), "rb") as f:
                data = f.read()
            if sniff_bytes(data) != "text":
                raise ValueError(
                    f"corpus dir {path} contains numpy tooling output "
                    f"({name!r}) — pass the .npy array directly as "
                    "--corpus, or keep only text files in the directory")
            parts.append(tokenize(data))
        return np.concatenate(parts)
    with open(path, "rb") as f:
        data = f.read()
    if sniff_bytes(data) != "text":
        raise ValueError(
            f"{path} is numpy tooling output, not text — load it with "
            "np.load (the train_lm CLI does this for .npy --corpus files "
            "automatically)")
    return tokenize(data)
