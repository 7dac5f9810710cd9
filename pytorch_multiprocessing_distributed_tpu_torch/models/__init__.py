"""Models of the port: the GPT family and the CIFAR ResNet family."""

from .gpt import GPT, GPT_Medium, GPT_Small, GPT_Tiny  # noqa: F401
from .registry import LM_MODELS, MODEL_REGISTRY, get_model  # noqa: F401
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50,  # noqa: F401
                     ResNet101, ResNet152, init_resnet, load_jax_resnet)
