"""Model registry (language models only, in this slice).

The JAX package's registry also carries the image zoo (ResNet, VGG,
...); those are ported with the training slice. Unknown names fail
loudly with the list of registered constructors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    """Decorator: add a model constructor under ``name``."""

    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """Instantiate a model by CLI name. Raises KeyError with the known
    names."""
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return ctor(**kwargs)
