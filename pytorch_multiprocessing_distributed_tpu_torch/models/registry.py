"""Model registry: the CLIs' model-selection seam (the port of the JAX
package's ``models/registry.py``).

The image entries are the JAX image zoo under the JAX names: the ResNet
family (``res`` is the reference's ResNet-18, then ``resnet18`` ...
``resnet152``), VGG (``vgg`` is VGG16, ``vgg11`` ... ``vgg19``),
DenseNet (``dense`` is DenseNet-121, ``densenet121``,
``densenet_bc100``), ViT (``vit_b16``, ``vit_s16``, ``vit_tiny``) and
ConvNeXt (``convnext_t/s/b/l``). Language models register with
``lm=True`` (the GPT family), which the image CLI rejects. Unknown names
fail loudly with the list of registered constructors.
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


def _without(kwargs, name):
    return {k: v for k, v in kwargs.items() if k != name}


def get_model(name: str, *, stem: str = None, image_size: int = None,
              **kwargs):
    """Instantiate a model by CLI name. Raises KeyError with the known
    names.

    ``stem`` is forwarded to the constructors that take it (the ResNet
    family) and dropped for the others, as the JAX ``get_model`` does, so
    the trainer can pass it per dataset. ``image_size`` is forwarded the
    same way: the port's ViT (its position table) and VGG (its flattened
    head) size themselves from it at construction, where flax infers
    those shapes from the first input."""
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}"
        ) from None
    optional = {k: v for k, v in (("stem", stem), ("image_size", image_size))
                if v is not None}
    while True:
        try:
            return ctor(**optional, **kwargs)
        except TypeError as e:
            # drop an optional argument the constructor does not take
            missing = [k for k in optional
                       if f"keyword argument '{k}'" in str(e)]
            if not missing:
                raise
            optional = _without(optional, missing[0])
