"""HF GPT-2 ``state_dict`` interop for the port's GPT (the port of the
JAX package's ``utils/gpt_interop.py``).

HF-format GPT-2 weights (``GPT2LMHeadModel`` / ``GPT2Model``
``state_dict``) load into :class:`..models.gpt.GPT`, and a trained GPT
exports to an HF-loadable ``state_dict``. The GPT is GPT-2 (pre-LN,
learned positions, tanh-GELU), so the mapping is structural. GPT-2's
``Conv1D`` keeps ``weight[in, out]``, which is the port's Dense
``kernel`` layout: nothing is transposed but the head.

====================  ==========================  ===============
port GPT              HF GPT-2                    transform
====================  ==========================  ===============
``embed`` [V, D]      ``wte.weight`` [V, D]       identity
``pos_embed`` [P, D]  ``wpe.weight`` [P, D]       identity
``block_i.ln1/ln2``   ``h.i.ln_1/ln_2``           scale<->weight
``attn.wqkv.kernel``  ``h.i.attn.c_attn.weight``  identity
``attn.wo.kernel``    ``h.i.attn.c_proj.weight``  identity
``fc1/fc2.kernel``    ``h.i.mlp.c_fc/c_proj``     identity
``ln_final``          ``ln_f``                    scale<->weight
``head.kernel``[D,V]  ``lm_head.weight`` [V, D]   transpose
====================  ==========================  ===============

GPT-2's tied head has no bias, so an import builds a ``head_bias=False``
model, and an export refuses a non-zero head bias rather than drop it.
GPT-2's LayerNorms use ``eps=1e-5``: the imported model is built with
``ln_eps=1e-5``. Params are the port's flat ``{name: tensor}`` dict
(``block_0.attn.wqkv.kernel``), as ``model.state_dict()`` holds them.
Only local files are read and written.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import torch

GPT2_LN_EPS = 1e-5

_BLOCK_RE = re.compile(r"^h\.(\d+)\.")

Params = Dict[str, torch.Tensor]


def _f32(t) -> torch.Tensor:
    """A CPU f32 copy of a tensor or array."""
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _normalize(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the ``transformer.`` prefix and drop the causal-mask buffers
    (``attn.bias``, ``attn.masked_bias``; the ``c_attn.bias`` parameter
    stays)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        if k.endswith(".attn.bias") or k.endswith(".attn.masked_bias"):
            continue
        out[k] = v
    return out


def gpt2_geometry(sd: Mapping[str, Any]) -> Dict[str, int]:
    """``vocab_size``, ``max_seq_len``, ``hidden_size``, ``num_layers``
    and ``mlp_dim`` of a GPT-2 state dict (``transformer.``-prefixed or
    not). ``num_heads`` is not in the weights: callers supply it."""
    sd = _normalize(sd)
    required = ("wte.weight", "wpe.weight", "h.0.mlp.c_fc.weight")
    missing = [k for k in required if k not in sd]
    if missing:
        raise ValueError(
            "state dict does not look like a GPT-2 checkpoint: missing "
            f"{missing} (have {len(sd)} keys, e.g. "
            f"{sorted(sd)[:3]}). Expected HF/nanoGPT-style keys "
            "('wte.weight', 'wpe.weight', 'h.N.*', optionally prefixed "
            "'transformer.').")
    v, d = sd["wte.weight"].shape
    p = sd["wpe.weight"].shape[0]
    layers = 1 + max(int(m.group(1)) for k in sd
                     if (m := _BLOCK_RE.match(k)))
    mlp = sd["h.0.mlp.c_fc.weight"].shape[1]
    return dict(vocab_size=int(v), max_seq_len=int(p), hidden_size=int(d),
                num_layers=int(layers), mlp_dim=int(mlp))


# (port name under block_i, HF name under h.i) of every block leaf
_BLOCK_LEAVES = (
    ("ln1.scale", "ln_1.weight"), ("ln1.bias", "ln_1.bias"),
    ("attn.wqkv.kernel", "attn.c_attn.weight"),
    ("attn.wqkv.bias", "attn.c_attn.bias"),
    ("attn.wo.kernel", "attn.c_proj.weight"),
    ("attn.wo.bias", "attn.c_proj.bias"),
    ("ln2.scale", "ln_2.weight"), ("ln2.bias", "ln_2.bias"),
    ("fc1.kernel", "mlp.c_fc.weight"), ("fc1.bias", "mlp.c_fc.bias"),
    ("fc2.kernel", "mlp.c_proj.weight"), ("fc2.bias", "mlp.c_proj.bias"),
)


def from_gpt2_state_dict(sd: Mapping[str, Any], num_heads: int,
                         **model_kw) -> Tuple["GPT", Params]:
    """``(model, params)``: a :class:`..models.gpt.GPT` of the
    checkpoint's geometry (``ln_eps=1e-5``, no head bias) and its flat
    CPU f32 params, to bind with ``model.load_state_dict(params,
    assign=True)``. ``model_kw`` overrides the model's keywords (e.g.
    ``dtype=torch.bfloat16``)."""
    from ..models.gpt import GPT

    sd = _normalize(sd)
    geo = gpt2_geometry(sd)
    if geo["hidden_size"] % num_heads:
        raise ValueError(
            f"hidden_size {geo['hidden_size']} not divisible by "
            f"num_heads={num_heads}")
    kw = dict(geo, num_heads=num_heads, ln_eps=GPT2_LN_EPS, head_bias=False)
    kw.update(model_kw)
    model = GPT(**kw)
    wte = _f32(sd["wte.weight"])
    head = _f32(sd["lm_head.weight"]) if "lm_head.weight" in sd else wte
    params: Params = {"embed": wte, "pos_embed": _f32(sd["wpe.weight"])}
    for i in range(geo["num_layers"]):
        for ours, theirs in _BLOCK_LEAVES:
            params[f"block_{i}.{ours}"] = _f32(sd[f"h.{i}.{theirs}"])
    params["ln_final.scale"] = _f32(sd["ln_f.weight"])
    params["ln_final.bias"] = _f32(sd["ln_f.bias"])
    params["head.kernel"] = head.T.contiguous()  # biasless, as the source
    return model, params


def to_gpt2_state_dict(params) -> "OrderedDict[str, torch.Tensor]":
    """The port's GPT params (a flat dict, or a bound model) as an
    HF-format ``state_dict``: CPU f32 tensors under ``transformer.*`` and
    ``lm_head.weight``, in the JAX export's key order.

    The head is untied, so ``lm_head.weight`` carries this model's head
    kernel: load it with ``GPT2Config(tie_word_embeddings=False)``. GPT-2
    has no head-bias slot, so a non-zero bias is refused rather than
    dropped (train with ``GPT(head_bias=False)`` for an exact export)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    bias = params.get("head.bias")
    if bias is not None and bool((bias != 0).any()):
        raise ValueError(
            "GPT-2 has no head-bias slot and this head's bias is "
            "non-zero — folding it away would change the logits. "
            "Train with GPT(head_bias=False) for exact export (or keep "
            "the framework checkpoint format).")
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["transformer.wte.weight"] = _f32(params["embed"])
    sd["transformer.wpe.weight"] = _f32(params["pos_embed"])
    i = 0
    while f"block_{i}.ln1.scale" in params:
        for ours, theirs in _BLOCK_LEAVES:
            sd[f"transformer.h.{i}.{theirs}"] = _f32(
                params[f"block_{i}.{ours}"])
        i += 1
    sd["transformer.ln_f.weight"] = _f32(params["ln_final.scale"])
    sd["transformer.ln_f.bias"] = _f32(params["ln_final.bias"])
    sd["lm_head.weight"] = _f32(params["head.kernel"]).T.contiguous()
    return sd


def load_gpt2_checkpoint(path: str, num_heads: int, **model_kw):
    """``torch.load`` a GPT-2 ``state_dict`` file -> ``(model,
    params)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not contain a state_dict")
    return from_gpt2_state_dict(sd, num_heads, **model_kw)


def save_gpt2_checkpoint(path: str, params) -> str:
    """Write the HF-format export with ``torch.save``; returns ``path``."""
    torch.save(to_gpt2_state_dict(params), path)
    return path
