"""The shared parts of the image CLI's tests
(``tests/test_torch_main_cli*.py``): both CLIs' fixtures, the JAX
``main.py`` loaded as a module, the log-row reader, and the ImageNet
cases' set and initialisation."""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_multiprocessing_distributed_tpu import models as jax_models
from pytorch_multiprocessing_distributed_tpu import train as jax_train
from pytorch_multiprocessing_distributed_tpu.parallel import make_mesh
from pytorch_multiprocessing_distributed_tpu.train import optim as jax_optim
from pytorch_multiprocessing_distributed_tpu.train.state import (
    TrainState as JaxTrainState)
from pytorch_multiprocessing_distributed_tpu_torch import (
    CudaUnavailableError)
from pytorch_multiprocessing_distributed_tpu_torch import main as port_main
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    load_jax_resnet)

from resnet_carry import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--synthetic", "--batch_size", "16", "--print-freq", "1", "--lr",
        "0.0001", "--seed", "0"]
FLAGS = BASE + ["--world_size", "1"]
ROW = re.compile(r"^\d{4} \d+\.\d{6} \d+\.\d{6}$")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_cpu_state(monkeypatch):
    """One intra-op thread, PyTorch's native convolutions and a small
    synthetic set, all restored after."""
    threads, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    monkeypatch.setenv("PMDT_SMALL_SYNTH", "32")
    yield
    torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn


@pytest.fixture(scope="module")
def variables():
    return random_variables(jax_models.get_model("res", bn_axis="data"),
                            seed=0, random_bn=False)


@pytest.fixture
def same_init(monkeypatch, variables):
    """Both CLIs start from ``variables``."""
    params, stats = variables

    def jax_state(model, rng, sample_input, optimizer, ema=False):
        # placed replicated on the CLI's 1-device mesh, as the jitted
        # step returns it: the step compiles once
        state = JaxTrainState(
            params=params, batch_stats=stats,
            opt_state=jax_optim.OptState(
                momentum=jax.tree.map(np.zeros_like, params),
                count=np.zeros((), np.int32),
                initialized=np.zeros((), np.bool_)),
            epoch=np.ones((), np.int32))
        return jax.device_put(state, NamedSharding(make_mesh(1, 1), P()))

    def port_init(model, seed=0):
        model.load_state_dict(load_jax_resnet(params, stats))
        return model

    monkeypatch.setattr(jax_train, "create_train_state", jax_state)
    monkeypatch.setattr(port_main, "init_model", port_init)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_image_main_cli", os.path.join(REPO, "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    lines = path.read_text().splitlines()
    assert all(ROW.match(line) for line in lines), lines
    return [[float(x) for x in line.split()] for line in lines]


# ---- the ImageNet route and LAMB through both CLIs ----
#
# Both CLIs on the synthetic ImageNet set cut to 4 train and 4 test
# images (the sets' constructors are wrapped for the test; the loaders,
# augmentations and shards are the CLIs' own), batch 4: one step an
# epoch, so the 3 epochs' train.log rows are a 3-step trajectory, each
# step's loss and accuracy, and test.log holds the eval after each.
# Both start from the same freshly drawn JAX variables
# (``tests/zoo_carry.py``), carried into the port.
#
# ConvNeXt-T under LAMB at lr 1e-5 (LayerNorm over one image and GELU: a
# smooth function of its weights) holds 1e-5 row by row.
#
# ResNet-50 from fresh weights at batch 4 is chaotic under SGD: its
# gradient norm is ~5e3, its BatchNorm takes ``E[x^2] - E[x]^2`` in f32
# over the 16 values a channel has in the last stage (4 images of 2x2),
# and its ReLUs meet pre-activations within 1e-6 of zero, where any
# change in the order of the sums flips a unit and moves the earlier
# gradients by up to 1% (``tests/test_torch_model_zoo.py``). Reversing
# only the order of each batch's rows moves the port's third loss by
# 0.14 at lr 1e-4 (by 0.20 at batch 16, 0.51 at batch 8), and JAX's
# likewise, so no two f32 runs agree along it. The ResNet-50 case runs
# at lr 1e-12: its three steps hold the ImageNet route (stem, data
# order and augmentation per epoch, BatchNorm statistics, eval) within
# 1e-5 or twice JAX's own move under that reversal, whichever is larger
# (~5e-5 on a train loss); the update itself is held at 1e-5 by the
# ConvNeXt case and, for SGD, by the CIFAR cases above.

IMAGENET = ["--dataset", "imagenet", "--synthetic", "--image_size", "64",
            "--batch_size", "4", "--epochs", "3", "--world_size", "1",
            "--print-freq", "1", "--seed", "0"]
TRAJ_TOL = 1e-5


def _tiny_synthetic(monkeypatch):
    """Cut both packages' synthetic ImageNet to 4 train / 4 test images
    (the split's ``seed`` tells them apart: 0 train, 1 test)."""
    from pytorch_multiprocessing_distributed_tpu.data import (
        imagenet as jax_imagenet)
    from pytorch_multiprocessing_distributed_tpu_torch.data import (
        imagenet as port_imagenet)

    for mod in (jax_imagenet, port_imagenet):
        class Tiny(mod.SyntheticImageNet):
            def __init__(self, n, **kw):
                super().__init__(4, **kw)

        monkeypatch.setattr(mod, "SyntheticImageNet", Tiny)


def _reverse_jax_batches(monkeypatch):
    """The JAX loader's batches in reverse row order (the same images,
    labels and masks; every sum over the batch runs the other way)."""
    from pytorch_multiprocessing_distributed_tpu.data import (
        imagenet as jax_imagenet)

    produce = jax_imagenet.IndexedLoader._produce

    def reversed_produce(self):
        for batch in produce(self):
            yield tuple(np.ascontiguousarray(a[::-1]) for a in batch)

    monkeypatch.setattr(jax_imagenet.IndexedLoader, "_produce",
                        reversed_produce)


@pytest.fixture
def carried_init(monkeypatch):
    """``use(jax_model_name, carry)``: both CLIs start from one set of
    fresh variables of that model (64x64 inputs, 1000 classes)."""
    from zoo_carry import random_variables

    def use(name, carry):
        model = jax_models.get_model(name, stem="imagenet",
                                     num_classes=1000)
        params, stats = random_variables(model, (2, 64, 64, 3), seed=0,
                                         fresh=True)

        def jax_state(model, rng, sample_input, optimizer, ema=False):
            state = JaxTrainState(
                params=params, batch_stats=stats,
                opt_state=optimizer.init(params),
                epoch=np.ones((), np.int32))
            return jax.device_put(state,
                                  NamedSharding(make_mesh(1, 1), P()))

        def port_init(model, seed=0):
            model.load_state_dict(carry(params, stats))
            return model

        monkeypatch.setattr(jax_train, "create_train_state", jax_state)
        monkeypatch.setattr(port_main, "init_model", port_init)

    return use

