"""Model registry: the CLIs' model-selection seam (the port of the JAX
package's ``models/registry.py``).

The image entries are the ResNet family under the reference's CLI name
``res`` (ResNet-18) and ``resnet18`` ... ``resnet152``; the rest of the
JAX image zoo (VGG, DenseNet, ViT, ConvNeXt) is not ported yet
(ROADMAP.md). Language models register with ``lm=True`` (the GPT
family), which the image CLI rejects. Unknown names fail loudly with the
list of registered constructors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Set

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}
# names registered with ``lm=True``: token-sequence models, which train
# through train_lm, not the image CLI
LM_MODELS: Set[str] = set()


def register(name: str, lm: bool = False):
    """Decorator: add a model constructor under ``name``; ``lm=True``
    marks a language model."""

    def deco(fn):
        MODEL_REGISTRY[name] = fn
        if lm:
            LM_MODELS.add(name)
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
