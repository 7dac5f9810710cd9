"""The port's ``utils/gpt_interop`` (HF GPT-2 ``state_dict`` to and from
the port's GPT) against the JAX package's, on the CPU.

Both packages export the same weights (a numpy tree, carried into the
port by ``from_jax_params``): the port's ``to_gpt2_state_dict`` equals
JAX's key for key, in JAX's order, bit for bit. Importing JAX's export
builds the port's GPT-2 configuration (LayerNorm eps 1e-5, no head
bias), whose logits are JAX's within 1e-5. Geometry inference, the
refusal of a non-zero head bias and the missing-key message are JAX's,
word for word; a file written by either package reads back in both.
Every ``state_dict`` is built here, without ``transformers``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu.utils import (
    gpt_interop as jax_interop)
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    from_jax_params)
from pytorch_multiprocessing_distributed_tpu_torch.utils import gpt_interop

from serving_tp_cases import _tree

GEOM = dict(vocab_size=61, max_seq_len=32, hidden_size=32, num_layers=3,
            num_heads=4, mlp_dim=64)
GPT2 = dict(ln_eps=1e-5, head_bias=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree():
    return _tree(dict(GEOM, **GPT2), 5)


def _jax_export(tree):
    return jax_interop.to_gpt2_state_dict(tree)


def test_export_equals_jax_key_for_key(tree):
    ours = gpt_interop.to_gpt2_state_dict(from_jax_params(tree))
    theirs = _jax_export(tree)
    assert list(ours) == list(theirs)
    for key, t in theirs.items():
        assert ours[key].dtype == torch.float32
        assert torch.equal(ours[key], t), key


def test_export_of_a_bound_model_equals_its_params(tree):
    model, _ = gpt_interop.from_gpt2_state_dict(_jax_export(tree),
                                                GEOM["num_heads"])
    model.load_state_dict(from_jax_params(tree), assign=True)
    sd = gpt_interop.to_gpt2_state_dict(model)
    for key, t in _jax_export(tree).items():
        assert torch.equal(sd[key], t), key


def test_import_of_jax_export_gives_jax_logits(tree):
    sd = _jax_export(tree)
    model, params = gpt_interop.from_gpt2_state_dict(sd, GEOM["num_heads"])
    assert model.ln_eps == 1e-5 and model.head.bias is None
    assert {k: getattr(model, k) for k in GEOM} == GEOM
    model.load_state_dict(params, assign=True)
    jmodel, jparams = jax_interop.from_gpt2_state_dict(
        sd, GEOM["num_heads"], attn_impl="xla")
    tokens = np.random.default_rng(0).integers(0, GEOM["vocab_size"], (2, 9))
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for name, t in params.items():  # the imported tree is the source's
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(from_jax_params(jparams)[name]))


def _hand_built(tree, tied):
    """An HF ``GPT2LMHeadModel``-style ``state_dict`` built by hand:
    ``transformer.``-prefixed, with the causal-mask buffers, and with the
    head tied to ``wte`` (no ``lm_head.weight``) where ``tied``."""
    sd = dict(_jax_export(tree))
    for i in range(GEOM["num_layers"]):
        s = GEOM["max_seq_len"]
        sd[f"transformer.h.{i}.attn.bias"] = torch.ones(1, 1, s, s).tril()
        sd[f"transformer.h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    if tied:
        del sd["lm_head.weight"]
    return sd


@pytest.mark.parametrize("tied", [False, True])
def test_geometry_and_import_of_a_hand_built_state_dict(tree, tied):
    sd = _hand_built(tree, tied)
    assert gpt_interop.gpt2_geometry(sd) == jax_interop.gpt2_geometry(sd)
    assert gpt_interop.gpt2_geometry(sd) == {
        k: GEOM[k] for k in ("vocab_size", "max_seq_len", "hidden_size",
                             "num_layers", "mlp_dim")}
    _, ours = gpt_interop.from_gpt2_state_dict(sd, GEOM["num_heads"])
    _, theirs = jax_interop.from_gpt2_state_dict(sd, GEOM["num_heads"])
    theirs = from_jax_params(theirs)
    assert set(ours) == set(theirs)
    for name in ours:
        assert torch.equal(ours[name], theirs[name]), name
    if tied:
        assert torch.equal(ours["head.kernel"], ours["embed"].T)


def test_refusals_speak_jax_words(tree):
    params = from_jax_params(tree)
    params["head.bias"] = torch.full((GEOM["vocab_size"],), 0.5)
    jtree = {k: v for k, v in tree.items()}
    jtree["head"] = dict(tree["head"], bias=np.full(GEOM["vocab_size"], 0.5,
                                                    np.float32))
    with pytest.raises(ValueError) as theirs:
        jax_interop.to_gpt2_state_dict(jtree)
    with pytest.raises(ValueError) as ours:
        gpt_interop.to_gpt2_state_dict(params)
    assert str(ours.value) == str(theirs.value)
    params["head.bias"] = torch.zeros(GEOM["vocab_size"])  # zero: exact
    assert "lm_head.weight" in gpt_interop.to_gpt2_state_dict(params)
    bad = {"transformer.wte.weight": torch.zeros(3, 2)}
    with pytest.raises(ValueError) as theirs:
        jax_interop.gpt2_geometry(bad)
    with pytest.raises(ValueError) as ours:
        gpt_interop.gpt2_geometry(bad)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as theirs:
        jax_interop.from_gpt2_state_dict(_jax_export(tree), 5)
    with pytest.raises(ValueError) as ours:
        gpt_interop.from_gpt2_state_dict(_jax_export(tree), 5)
    assert str(ours.value) == str(theirs.value)


def test_file_round_trip_across_packages(tree, tmp_path):
    ours_path = gpt_interop.save_gpt2_checkpoint(
        str(tmp_path / "port.hf.pth"), from_jax_params(tree))
    theirs_path = jax_interop.save_gpt2_checkpoint(
        str(tmp_path / "jax.hf.pth"), tree)
    for path in (ours_path, theirs_path):
        model, params = gpt_interop.load_gpt2_checkpoint(
            path, GEOM["num_heads"])
        assert model.ln_eps == 1e-5
        _, jparams = jax_interop.load_gpt2_checkpoint(path,
                                                      GEOM["num_heads"])
        want = from_jax_params(jparams)
        for name, t in from_jax_params(tree).items():
            assert torch.equal(params[name], t), (path, name)
            assert torch.equal(want[name], t), (path, name)
    torch.save([1, 2], tmp_path / "list.pth")
    with pytest.raises(ValueError, match="does not contain a state_dict"):
        gpt_interop.load_gpt2_checkpoint(str(tmp_path / "list.pth"), 4)
