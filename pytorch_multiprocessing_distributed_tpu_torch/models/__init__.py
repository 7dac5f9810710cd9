"""Models of the port (the GPT family, in this slice)."""

from .gpt import GPT, GPT_Medium, GPT_Small, GPT_Tiny  # noqa: F401
from .registry import MODEL_REGISTRY, get_model  # noqa: F401
