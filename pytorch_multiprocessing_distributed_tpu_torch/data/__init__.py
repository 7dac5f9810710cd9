"""Data pipelines of the port: LM token streams, CIFAR-10 and ImageNet
images."""

from .cifar import load_cifar10, synthetic_cifar10  # noqa: F401
from .imagenet import (FolderImageNet, IndexedLoader,  # noqa: F401
                       SyntheticImageNet, normalize_imagenet)
from .lm import TokenLoader, synthetic_tokens  # noqa: F401
from .pipeline import ShardedLoader, get_loader, prefetch  # noqa: F401
from .text import (detokenize, load_text_corpus, sniff_bytes,  # noqa: F401
                   tokenize)
from .transforms import normalize, random_crop_flip  # noqa: F401
