"""The port's Mixture-of-Experts layer, model and dropless decode on the
card against the same code on the CPU (every test here is marked
``cuda`` and skips on a machine without one). This file imports neither
jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py

The layer (B 4, S 64, D 64, H 128, E 4; top-1 and top-2; capacity
factor 1.0, so tokens drop): every route and kept slot equal (the router
is f32 on both devices; these inputs hold no near tie), ``y``, ``aux``
and ``z`` within 1e-5 in f32 with TF32 off and ``y`` within 2e-2 in
bf16 (one bf16 rounding of the experts' products and of the combine),
the f32 gradients of every leaf within 1e-4. An MoE GPT's logits and
layer-mean losses on the card within 1e-4 of the CPU's, its f32 train
step's loss and balance loss within 1e-4 after 2 steps, and greedy
``generate`` token-exact between the two devices in f32 (dropless
decode on the decode kernel).
"""

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch.inference import generate
from pytorch_multiprocessing_distributed_tpu_torch.models import GPT
from pytorch_multiprocessing_distributed_tpu_torch.ops.moe import (
    MoEMlp, dispatch_masks, route)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    init_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_lm_train_state, make_lm_train_step, sgd)

pytestmark = pytest.mark.cuda

B, S, D, H, E = 4, 64, 64, 128, 4
GEOM = dict(vocab_size=97, max_seq_len=64, hidden_size=D, num_layers=2,
            num_heads=2, mlp_dim=H, n_experts=E)


@pytest.fixture
def cuda_device():
    """The card, TF32 off for the f32 comparisons; the test skips without
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = before


def _layer(k, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"gate": torch.randn((D, E), generator=gen) * D ** -0.5,
              "w1": torch.randn((E, D, H), generator=gen) * D ** -0.5,
              "b1": 0.1 * torch.randn((E, H), generator=gen),
              "w2": torch.randn((E, H, D), generator=gen) * H ** -0.5,
              "b2": 0.1 * torch.randn((E, D), generator=gen)}
    m = MoEMlp(D, E, H, 1.0, k)
    m.load_state_dict({n: t.to(device) for n, t in params.items()},
                      assign=True)
    for p in m.parameters():
        p.requires_grad_(True)
    return m


@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, k):
    x = torch.randn((B, S, D), generator=torch.Generator().manual_seed(1))
    dy = torch.randn((B, S, D), generator=torch.Generator().manual_seed(2))
    outs = []
    for dev in ("cpu", cuda_device):
        m = _layer(k, dev)
        xx = x.detach().to(dev).requires_grad_()
        y, aux, z = m(xx)
        torch.autograd.backward([y, aux, z], [dy.to(dev),
                                              torch.ones_like(aux),
                                              torch.ones_like(z)])
        _, _, _, topi = route(m.gate, xx, k)
        _, slots, kept = dispatch_masks(
            torch.nn.functional.one_hot(topi, E).float(), m.capacity(S))
        outs.append({"y": y, "aux": aux, "z": z, "dx": xx.grad,
                     **{f"d{n}": p.grad for n, p in m.named_parameters()},
                     "routes": topi, "slots": slots, "kept": kept})
    cpu, card = outs
    assert not bool(cpu["kept"].all())  # the capacity binds
    for name in ("routes", "slots", "kept"):
        assert torch.equal(card[name].cpu(), cpu[name]), name
    for name in ("y", "aux", "z"):
        torch.testing.assert_close(card[name].cpu(), cpu[name], atol=1e-5,
                                   rtol=0, msg=name)
    for name in ("dx", "dgate", "dw1", "db1", "dw2", "db2"):
        torch.testing.assert_close(card[name].cpu(), cpu[name], atol=1e-4,
                                   rtol=0, msg=name)


@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
def test_moe_layer_bf16_on_the_card(cuda_device, k):
    x = torch.randn((B, S, D), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, _, _ = _layer(k, "cpu")(x, torch.bfloat16)
        got, _, _ = _layer(k, cuda_device)(x.to(cuda_device), torch.bfloat16)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), ref, atol=2e-2, rtol=0)


def _gpt(device, k=1):
    model = GPT(**GEOM, moe_top_k=k)
    model.load_state_dict(init_params(model, 0, device), assign=True)
    return model


@pytest.mark.parametrize("k", [1, 2], ids=["top1", "top2"])
def test_moe_gpt_forward_step_and_decode_on_the_card(cuda_device, k):
    tokens = torch.randint(0, 97, (B, S),
                           generator=torch.Generator().manual_seed(3))
    res = {}
    for dev in ("cpu", cuda_device):
        model = _gpt(dev, k)
        with torch.no_grad():
            logits, aux, z = model(tokens.to(dev), moe_losses=True)
            out = generate(model, tokens[:2, :8].to(dev), max_new_tokens=12)
        state = create_lm_train_state(model, init_params(model, 0, dev))
        step = make_lm_train_step(model, sgd(0.1))
        metrics = [step(state, tokens.to(dev))[1] for _ in range(2)]
        res[str(dev)] = dict(
            logits=logits.cpu(), aux=aux.cpu(), z=z.cpu(), out=out.cpu(),
            loss=[float(m["loss"]) for m in metrics],
            moe_aux=[float(m["moe_aux"]) for m in metrics])
    cpu, card = res["cpu"], res[str(cuda_device)]
    for name in ("logits", "aux", "z"):
        torch.testing.assert_close(card[name], cpu[name], atol=1e-4, rtol=0,
                                   msg=name)
    assert torch.equal(card["out"], cpu["out"])
    for name in ("loss", "moe_aux"):
        assert max(abs(a - b) for a, b in zip(card[name], cpu[name])) < 1e-4
