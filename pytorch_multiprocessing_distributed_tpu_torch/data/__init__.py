"""Data pipelines of the port (LM token streams, in this slice)."""

from .lm import TokenLoader, synthetic_tokens  # noqa: F401
from .text import (detokenize, load_text_corpus, sniff_bytes,  # noqa: F401
                   tokenize)
