"""Vision Transformer (the port of the JAX package's ``models/vit.py``;
BASELINE config #4, ViT-B/16).

Patch embedding (a conv with bias, stride = kernel = patch), a class
token (zero-initialised) before the patches, a learned ``pos_embed``,
pre-LN encoder blocks, a final LayerNorm and an f32 head on the class
token. As in flax: LayerNorm eps 1e-6, computed in f32; GELU is the tanh
approximation; Dense kernels and the head are ``lecun_normal``. ``dtype``
is the compute dtype of the convs, Dense layers and attention; params
stay f32 and the logits come out f32.

Attention: ``flash=False`` (what the CLI builds) is the JAX einsum
attention in torch ops — logits in the compute dtype, softmax in f32,
the probabilities cast back for the product with V. ``flash=True`` calls
:func:`..ops.flash_attention.flash_attention` non-causally: kernel rows
5-7 on the card, their plain versions on the CPU. ``seq_axis`` names a
grid axis (:func:`..parallel.mesh.make_grid` with ``axis="seq"``) to run
the encoder's attention over, as JAX's ``models/vit.py`` does: each
rank embeds its own input (patches, class token, positions), and
attention runs :func:`..parallel.ring_attention.ring_attention`
(non-causal), its keys and values the union of every rank's sequence
(rows 5-7 once a hop on the card); every other op stays local.

Module names are the flax ones (``patch_embed``, ``cls``, ``pos_embed``,
``encoder_{i}.{ln1,attn.qkv,attn.proj,ln2,mlp.fc1,mlp.fc2}``,
``ln_final``, ``head``), so :func:`load_jax_vit` carries a JAX tree
across. ``image_size`` sizes ``pos_embed`` (flax infers it from the
first input).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import ring_attention
from .init import carry_jax_variables
from .registry import register

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=f32)``: in f32, f32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS)


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A flax ``Dense`` in ``x``'s dtype (the f32 params cast to it)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return dense(self.fc2, gelu(dense(self.fc1, x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, flash: bool = False,
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.flash = flash
        self.seq_axis = seq_axis
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, d = x.shape
        h = self.num_heads
        q, k, v = dense(self.qkv, x).view(b, s, 3, h, d // h).unbind(2)
        if self.seq_axis is not None:
            out = ring_attention(q, k, v, axis_name=self.seq_axis,
                                 causal=False)
        elif self.flash:
            out = flash_attention(q, k, v)
        else:
            scale = (d // h) ** -0.5
            logits = torch.einsum("bqhc,bkhc->bhqk", q, k) * scale
            probs = torch.softmax(logits.float(), dim=-1)
            out = torch.einsum("bhqk,bkhc->bqhc", probs.to(x.dtype), v)
        return dense(self.proj, out.reshape(b, s, d))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 flash: bool = False, seq_axis: Optional[str] = None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, flash, seq_axis)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(layer_norm(self.ln1, x).to(x.dtype))
        return x + self.mlp(layer_norm(self.ln2, x).to(x.dtype))


class ViT(nn.Module):
    """Input ``[batch, image_size, image_size, 3]`` NHWC, output
    ``[batch, num_classes]`` f32 logits."""

    def __init__(self, patch_size: int = 16, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 seq_axis: Optional[str] = None, flash: bool = False):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(
                f"image_size {image_size} is no multiple of the patch "
                f"{patch_size}")
        self.dtype = dtype
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.patch_embed = nn.Conv2d(3, hidden_size, patch_size,
                                     stride=patch_size)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden_size))
        seq = (image_size // patch_size) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, seq, hidden_size))
        for i in range(num_layers):
            self.add_module(f"encoder_{i}", EncoderBlock(
                hidden_size, num_heads, mlp_dim, flash, seq_axis))
        self.ln_final = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.head = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, dt = x.shape[0], self.dtype
        pe = self.patch_embed
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), pe.weight.to(dt),
                     pe.bias.to(dt), pe.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, S, D], patches row-major
        cls = self.cls.to(dt).expand(b, 1, self.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for i in range(self.num_layers):
            x = getattr(self, f"encoder_{i}")(x)
        x = layer_norm(self.ln_final, x)[:, 0]  # the class token, f32
        return F.linear(x, self.head.weight, self.head.bias)


def ViT_B16(**kw) -> ViT:
    return ViT(patch_size=16, hidden_size=768, num_layers=12, num_heads=12,
               mlp_dim=3072, **kw)


def ViT_S16(**kw) -> ViT:
    return ViT(patch_size=16, hidden_size=384, num_layers=12, num_heads=6,
               mlp_dim=1536, **kw)


def ViT_Tiny(**kw) -> ViT:
    """4x4-patch tiny ViT for 32x32 smoke runs under the CIFAR trainer."""
    kw.setdefault("image_size", 32)
    return ViT(patch_size=4, hidden_size=192, num_layers=6, num_heads=3,
               mlp_dim=768, **kw)


register("vit_b16")(ViT_B16)
register("vit_s16")(ViT_S16)
register("vit_tiny")(ViT_Tiny)


def load_jax_vit(params, batch_stats=None):
    """A JAX ViT's ``params`` as the port's ``state_dict``
    (:func:`.init.carry_jax_variables`)."""
    return carry_jax_variables(params, batch_stats)
