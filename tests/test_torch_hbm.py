"""The port's device-memory ledger against the JAX package's.

``HbmLedger`` gives JAX's snapshot for the same registrations (one test
over both modules); ``nbytes_of`` reads a tensor's bytes from its
metadata as JAX reads an array's; and the trainers' and ``generate``'s
registrations hold JAX's entries, categories and bytes on the same
models: the image state (ResNet-18 with BatchNorm stats, under SGD with
an EMA and under LAMB) and gpt_tiny's LM state. The serving pools' and
the engine's entries are pinned in ``tests/test_torch_scope_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu.inference.generate import (
    register_generate_hbm as jax_register_generate_hbm)
from pytorch_multiprocessing_distributed_tpu.ops.kv_quant import (
    QuantizedKV as JaxQuantizedKV)
from pytorch_multiprocessing_distributed_tpu.runtime import hbm as jhbm
from pytorch_multiprocessing_distributed_tpu.train import lamb as jax_lamb
from pytorch_multiprocessing_distributed_tpu.train import lm as jax_lm
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train.state import (
    create_train_state as jax_create_train_state)
from pytorch_multiprocessing_distributed_tpu.train.step import (
    register_state_hbm as jax_register_state_hbm)
from pytorch_multiprocessing_distributed_tpu_torch.inference.generate import (
    register_generate_hbm)
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    get_model, init_model)
from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
    QuantizedKV)
from pytorch_multiprocessing_distributed_tpu_torch.runtime import hbm
from pytorch_multiprocessing_distributed_tpu_torch.serving import (
    init_params)
from pytorch_multiprocessing_distributed_tpu_torch.train import (
    create_lm_train_state, create_train_state, lamb, sgd)
from pytorch_multiprocessing_distributed_tpu_torch.train.step import (
    register_state_hbm)

MODS = pytest.mark.parametrize("mod", [jhbm, hbm], ids=["jax", "port"])


@MODS
def test_ledger_snapshot_equals_jax(mod):
    def run(m):
        ledger = m.HbmLedger()
        ledger.register("serving.params", 1000, category="params")
        ledger.register("serving.kv-pool", 4096, category="kv", slots=8)
        ledger.register("train.opt_state", 7, category="opt_state")
        ledger.update("train.opt_state", 9)
        ledger.set_gauge("pages_in_use", 3)
        ledger.release("nope")
        ledger.release("serving.params")
        with pytest.raises(KeyError):
            ledger.update("missing", 1)
        with pytest.raises(ValueError):
            ledger.register("neg", -1)
        return (ledger.snapshot(), ledger.breakdown(), ledger.total_bytes,
                ledger.entries())

    assert run(mod) == run(jhbm)
    with mod.scoped_ledger() as ledger:
        mod.register("a", 5, category="x")
        mod.set_gauge("g", 2)
        assert mod.active_ledger() is ledger
    assert mod.active_ledger() is None
    mod.register("b", 1)  # disarmed: a no-op


def test_nbytes_of_reads_metadata_as_jax():
    for shape, tdtype, jdtype in (((3, 5), torch.float32, jnp.float32),
                                  ((2, 4, 8), torch.bfloat16, jnp.bfloat16),
                                  ((7,), torch.int8, jnp.int8),
                                  ((), torch.bool, jnp.bool_)):
        t = torch.zeros(shape, dtype=tdtype)
        a = jnp.zeros(shape, jdtype)
        assert hbm.nbytes_of(t) == jhbm.nbytes_of(a)
        assert hbm.shard_nbytes(t) == jhbm.shard_nbytes(a)
    pair = QuantizedKV(torch.zeros((2, 4, 8), dtype=torch.int8),
                       torch.ones((2, 4), dtype=torch.float32))
    jpair = JaxQuantizedKV(jnp.zeros((2, 4, 8), jnp.int8),
                           jnp.ones((2, 4), jnp.float32))
    assert hbm.nbytes_of(pair) == jhbm.shard_nbytes(jpair) == 2 * 4 * 12
    assert hbm.tree_nbytes({"a": [torch.zeros(3), None], "b": ()}) == 12
    assert hbm.nbytes_of(np.zeros((2, 3), np.float64)) == 48
    with pytest.raises(TypeError):
        hbm.nbytes_of("not an array")


def _entries(register, *args):
    with (jhbm if register is jax_register_state_hbm
          or register is jax_register_generate_hbm
          else hbm).scoped_ledger() as ledger:
        register(*args)
    return ledger.entries()


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_image_state_entries_equal_jax(optimizer):
    jmodel = jax_models.get_model("res", bn_axis=None)
    if optimizer == "sgd":
        jopt, opt, ema = jax_optim.sgd(0.1, momentum=0.9), sgd(0.1), True
    else:
        jopt, opt, ema = jax_lamb.lamb(1e-3), lamb(1e-3), False
    jstate = jax_create_train_state(jmodel, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3)), jopt,
                                    ema=ema)
    model = init_model(get_model("res"), 0)
    state = create_train_state(model, opt, ema=ema)
    got = _entries(register_state_hbm, state)
    want = _entries(jax_register_state_hbm, jstate)
    assert got == want
    assert ("train.ema_params" in got) == ema
    assert "train.batch_stats" in got


def test_lm_state_and_generate_entries_equal_jax():
    jmodel = jax_models.get_model("gpt_tiny", dtype=jnp.float32,
                                  n_experts=0)
    jstate = jax_lm.create_lm_train_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32),
        jax_optim.sgd(0.1))
    model = get_model("gpt_tiny")
    state = create_lm_train_state(model, init_params(model, 0, "cpu"))
    got = _entries(register_state_hbm, state)
    assert got == _entries(jax_register_state_hbm, jstate)
    assert sorted(got) == ["train.opt_state", "train.params"]
    assert (_entries(register_generate_hbm, model, 1, 36)
            == _entries(jax_register_generate_hbm, jmodel, 1, 36))
