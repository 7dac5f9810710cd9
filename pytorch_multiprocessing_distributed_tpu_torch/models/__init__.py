"""Models of the port: the GPT family and the JAX image zoo (ResNet,
VGG, DenseNet, ViT, ConvNeXt); importing a family registers its CLI
names."""

from .convnext import (ConvNeXt, ConvNeXt_B, ConvNeXt_L,  # noqa: F401
                       ConvNeXt_S, ConvNeXt_T, load_jax_convnext)
from .densenet import (DenseNet, DenseNet121,  # noqa: F401
                       DenseNetBC100, load_jax_densenet)
from .gpt import GPT, GPT_Medium, GPT_Small, GPT_Tiny  # noqa: F401
from .init import carry_jax_variables, init_model  # noqa: F401
from .registry import LM_MODELS, MODEL_REGISTRY, get_model  # noqa: F401
from .resnet import (ResNet, ResNet18, ResNet34, ResNet50,  # noqa: F401
                     ResNet101, ResNet152, init_resnet, load_jax_resnet)
from .vgg import VGG, VGG11, VGG13, VGG16, VGG19, load_jax_vgg  # noqa: F401
from .vit import ViT, ViT_B16, ViT_S16, ViT_Tiny, load_jax_vit  # noqa: F401
