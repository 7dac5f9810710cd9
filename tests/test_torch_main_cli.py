"""The port's image CLI (``pytorch_multiprocessing_distributed_tpu_torch.main``)
on the CPU, against the JAX package's ``main.py`` run on the same tiny
synthetic set (``PMDT_SMALL_SYNTH=32``: 32 train and 8 test images).

Both CLIs start from the same ResNet-18 weights (numpy draws carried
into each: the JAX CLI's ``create_train_state`` and the port's
``init_model`` are replaced for the test) and read the same shards in
the same order. Their ``train.log``/``test.log`` rows agree within 1e-4
after 2 epochs (4 steps of 16 augmented images): two frameworks' f32
sums in different orders, with the port on PyTorch's native CPU
convolutions (oneDNN off, restored after; see
``tests/test_torch_image_train.py``). At lr 1e-4: this trajectory
(batch 16 of zero-padded random crops through BatchNorm) magnifies
rounding so much at larger steps that JAX on 1 and on 2 devices, from
the same weights and batches, already differ by 1.2e-3 in the second
step's loss at lr 0.01 and by 1.3e-4 at lr 0.001, but by < 1e-5 at
1e-4.
"""

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


def test_logs_match_jax_cli(tmp_path, same_init, capsys):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = _jax_cli()
    cli.run_model(cli.parser.parse_args(
        FLAGS + ["--epochs", "2", "--save_path", str(jax_dir)]))
    capsys.readouterr()
    summary = port_main.main(FLAGS + ["--epochs", "2", "--device", "cpu",
                                      "--optimizer", "sgd_fused",
                                      "--save_path", str(port_dir)])
    out = capsys.readouterr().out
    assert "Train Dataset : 32    Test Dataset : 8" in out
    assert re.search(r"^Epoch: \[2\]\[1/2\]\tTime \d+\.\d{3} \(\d+\.\d{3}\)\t"
                     r"Data .*\tLoss \d+\.\d{4} \(\d+\.\d{4}\)\t"
                     r"Prec \d+\.\d{3}% \(\d+\.\d{3}%\)$", out, re.M)
    assert re.search(r"^test : \[0/1\]\tTime .*\tLoss ", out, re.M)
    assert re.search(r"^Accuracy \d+\.\d{2}$", out, re.M)
    for name in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / name), _rows(jax_dir / name)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0]
        for a, b in zip(ours, ref):
            assert abs(a[1] - b[1]) < TOL, (name, a, b)
            assert abs(a[2] - b[2]) < TOL, (name, a, b)
    for name in ("main.py", "model_2.pth", "model_2.pth.sha256",
                 "test_accuracy.png", "loss.png"):
        assert (port_dir / name).exists(), name
    snapshot = (port_dir / "main.py").read_text()
    assert snapshot == open(port_main.__file__).read()
    assert summary["steps"] == 4 and summary["world_size"] == 1
    assert summary["launches"] == {"fused_sgd": 0}  # the CPU: plain path
    assert summary["epoch_losses"] == pytest.approx(
        [r[1] for r in _rows(port_dir / "train.log")], abs=1e-6)


def test_logs_match_jax_cli_cosine_warmup(tmp_path, same_init, capsys):
    """``--lr_schedule cosine --warmup_epochs 1`` through both CLIs over
    3 epochs (lr x1, x1, x0.5): the rows agree within 1e-4. The third
    epoch's rows are where the schedule shows: at MultiStepLR's constant
    lr they move by ~1e-3 (train) and ~1.5e-4 (test)."""
    flags = FLAGS + ["--epochs", "3", "--lr_schedule", "cosine",
                     "--warmup_epochs", "1"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = _jax_cli()
    cli.run_model(cli.parser.parse_args(flags + ["--save_path",
                                                 str(jax_dir)]))
    port_main.main(flags + ["--device", "cpu", "--save_path",
                            str(port_dir)])
    capsys.readouterr()
    for name in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / name), _rows(jax_dir / name)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0,
                                                               3.0]
        for a, b in zip(ours, ref):
            assert abs(a[1] - b[1]) < TOL, (name, a, b)
            assert abs(a[2] - b[2]) < TOL, (name, a, b)


def test_resume_auto_continues(tmp_path, capsys, monkeypatch):
    """``--resume auto`` picks up the newest checkpoint and continues at
    the next epoch; the resumed run equals the straight one (one step
    an epoch: 16 images)."""
    monkeypatch.setenv("PMDT_SMALL_SYNTH", "16")
    straight, split = tmp_path / "straight", tmp_path / "split"
    port_main.main(FLAGS + ["--epochs", "2", "--device", "cpu",
                            "--save_path", str(straight)])
    port_main.main(FLAGS + ["--epochs", "1", "--device", "cpu",
                            "--save_path", str(split)])
    capsys.readouterr()
    port_main.main(FLAGS + ["--epochs", "2", "--device", "cpu", "--resume",
                            "auto", "--save_path", str(split)])
    assert "continuing at epoch 2" in capsys.readouterr().out
    for name in ("train.log", "test.log"):
        ours, ref = _rows(split / name), _rows(straight / name)
        assert len(ours) == 2
        assert sum(ours, []) == pytest.approx(sum(ref, []), rel=1e-5)
    assert (split / "model_2.pth").exists()


def test_world2_spawns_gloo_ranks(tmp_path):
    """``--world_size 2 --device cpu`` without the ``PMDT_*`` env spawns
    two gloo ranks (their numbers are held against JAX on 2 devices in
    ``tests/test_torch_image_train.py``): each takes half of every global
    batch, and only the primary rank writes the rows, the checkpoint and
    the plots."""
    summary = port_main.main(BASE + ["--epochs", "1", "--device", "cpu",
                                     "--world_size", "2", "--save_path",
                                     str(tmp_path)])
    assert summary["world_size"] == 2 and summary["steps"] == 2
    assert summary["device"] == "cpu"
    # the world's rate and one card's: each rank takes half of a batch
    assert summary["images_per_sec_per_card"] == pytest.approx(
        summary["images_per_sec"] / 2)
    for name in ("train.log", "test.log"):
        rows = _rows(tmp_path / name)
        assert len(rows) == 1 and rows[0][0] == 1.0
        assert np.isfinite(rows[0][1])
    assert summary["epoch_losses"][0] == pytest.approx(
        _rows(tmp_path / "train.log")[0][1], abs=1e-6)
    for name in ("main.py", "model_1.pth", "loss.png"):
        assert (tmp_path / name).exists(), name


_UNPORTED = [
    (["--ckpt_backend", "orbax"], "--ckpt_backend"),
    (["--ckpt_async"], "--ckpt_async"),
    (["--profile", "prof"], "--profile"),
    (["--max_restarts", "1"], "--max_restarts"),
    (["--stats_port", "9137"], "--stats_port"),
    (["--trace_out", "t.json"], "--trace_out"),
    (["--events_out", "e.jsonl"], "--events_out"),
    (["--flight_path", "f.jsonl"], "--flight_path"),
]


# each case keeps the id it had while --model_parallel, --zero1 and
# --fsdp led this list (they are ported now)
@pytest.mark.parametrize("extra,flag", _UNPORTED, ids=[
    f"extra{i + 3}-{flag}" for i, (_, flag) in enumerate(_UNPORTED)])
def test_unported_flags_are_rejected_by_name(tmp_path, extra, flag):
    with pytest.raises(SystemExit, match=(
            f"^{re.escape(flag)} is not ported.*ROADMAP.md §1 item 5")):
        port_main.main(FLAGS + ["--device", "cpu", "--save_path",
                                str(tmp_path / "run")] + extra)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("extra", [["--optimizer", "lamb"],
                                   ["--dataset", "imagenet"],
                                   ["--grad_accum", "2"],
                                   ["--clip_grad_norm", "1.0"],
                                   ["--ema", "0.999"], ["--remat"],
                                   ["--zero"], ["--torch_export"],
                                   ["--zero1"], ["--fsdp"],
                                   ["--model_parallel", "2"],
                                   ["--model_parallel", "2", "--zero1",
                                    "--optimizer", "lamb"]])
def test_ported_flags_are_accepted(extra):
    """The flags this port has taken out of the rejected list pass the
    CLI's checks (their runs are held against JAX below)."""
    args = port_main.build_parser().parse_args(FLAGS + extra)
    port_main._reject_not_ported(args)
    port_main._check_flags(args)


def test_flag_checks(tmp_path):
    run = ["--device", "cpu", "--save_path", str(tmp_path)]
    with pytest.raises(SystemExit, match="language model"):
        port_main.main(run + ["--model", "gpt_tiny"])
    with pytest.raises(SystemExit, match="--warmup_epochs"):
        port_main.main(run + ["--warmup_epochs", "1"])
    with pytest.raises(SystemExit, match="32x32"):
        port_main.main(run + ["--image_size", "64"])
    with pytest.raises(KeyError, match="Unknown model"):
        port_main.main(run + FLAGS + ["--model", "alexnet"])
    assert port_main.build_parser().parse_args([]).world_size == 2


def test_card_is_the_default_and_ranks_need_cards(tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI asks for the card; asking for
    more ranks than cards fails instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(CudaUnavailableError):
        port_main.main(FLAGS + ["--save_path", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 4 CUDA devices, this "
                                         "machine has 1"):
        port_main.main(["--world_size", "4", "--synthetic", "--save_path",
                        str(tmp_path)])


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_draw_plot_writes_both_pngs(tmp_path, monkeypatch, with_matplotlib):
    """The two curve PNGs, through matplotlib, or without it through the
    standard-library renderer (train blue, test red on a white canvas)."""
    import sys
    import zlib

    from pytorch_multiprocessing_distributed_tpu_torch.utils import (
        Logger, draw_plot)

    for name, rows in (("train.log", [[1, 2.5, 10.0], [2, 1.5, 40.0]]),
                       ("test.log", [[1, 2.2, 20.0], [2, 1.9, 30.0]])):
        log = Logger(str(tmp_path / name))
        for row in rows:
            log.write(row)
    if not with_matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    draw_plot(str(tmp_path))
    for name in ("test_accuracy.png", "loss.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n", name
        if not with_matplotlib:
            idat = data.index(b"IDAT")
            size = int.from_bytes(data[idat - 4:idat], "big")
            raw = zlib.decompress(data[idat + 4:idat + 4 + size])
            assert len(raw) == 480 * (1 + 640 * 3)
            assert b"\x00\x00\xff" in raw and b"\xff\x00\x00" in raw


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


@pytest.mark.parametrize("name,flags", [
    ("resnet50", ["--model", "resnet50", "--lr", "1e-12"]),
    ("convnext_t", ["--model", "convnext_t", "--optimizer", "lamb",
                    "--lr", "0.00001"]),
])
def test_imagenet_trajectory_matches_jax_cli(tmp_path, monkeypatch, capsys,
                                             carried_init, name, flags):
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        load_jax_convnext)

    carried_init(name, load_jax_resnet if name == "resnet50"
                 else load_jax_convnext)
    _tiny_synthetic(monkeypatch)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = _jax_cli()
    cli.run_model(cli.parser.parse_args(
        IMAGENET + flags + ["--save_path", str(jax_dir)]))
    moves = {log: [0.0] * 3 for log in ("train.log", "test.log")}
    if name == "resnet50":
        rev_dir = tmp_path / "jax_reversed"
        _reverse_jax_batches(monkeypatch)
        cli.run_model(cli.parser.parse_args(
            IMAGENET + flags + ["--save_path", str(rev_dir)]))
        for log in moves:
            moves[log] = [abs(a[1] - b[1]) for a, b in zip(
                _rows(jax_dir / log), _rows(rev_dir / log))]
    summary = port_main.main(IMAGENET + flags + [
        "--device", "cpu", "--save_path", str(port_dir)])
    out = capsys.readouterr().out
    assert "Train Dataset : 4    Test Dataset : 4" in out
    for log in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / log), _rows(jax_dir / log)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0,
                                                               3.0]
        for a, b, move in zip(ours, ref, moves[log]):
            bound = max(TRAJ_TOL, 2 * move)
            assert abs(a[1] - b[1]) < bound, (log, a, b, bound)
            assert abs(a[2] - b[2]) < TRAJ_TOL, (log, a, b)
    assert summary["steps"] == 3
    # the three losses differ: the trajectory moves
    assert len({r[1] for r in _rows(port_dir / "train.log")}) == 3


def test_lamb_resume_round_trips(tmp_path, monkeypatch, capsys):
    """A LAMB run resumed from its epoch-1 checkpoint (params, BN stats,
    ``opt_state/mu``, ``opt_state/nu``, ``opt_state/count``) equals the
    straight run; the payload holds LAMB's moments, not momenta."""
    _tiny_synthetic(monkeypatch)
    flags = ["--dataset", "imagenet", "--synthetic", "--image_size", "32",
             "--batch_size", "4", "--world_size", "1", "--model",
             "vit_tiny", "--optimizer", "lamb", "--device", "cpu"]
    straight, split = tmp_path / "straight", tmp_path / "split"
    port_main.main(flags + ["--epochs", "2", "--save_path", str(straight)])
    port_main.main(flags + ["--epochs", "1", "--save_path", str(split)])
    payload = torch.load(split / "model_1.pth", weights_only=True)
    assert int(payload["opt_state/count"]) == 1
    assert any(k.startswith("opt_state/nu/") for k in payload)
    assert not any(k.startswith("opt_state/momentum/") for k in payload)
    capsys.readouterr()
    port_main.main(flags + ["--epochs", "2", "--resume", "auto",
                            "--save_path", str(split)])
    assert "continuing at epoch 2" in capsys.readouterr().out
    for log in ("train.log", "test.log"):
        assert _rows(split / log) == _rows(straight / log)
    a = torch.load(split / "model_2.pth", weights_only=True)
    b = torch.load(straight / "model_2.pth", weights_only=True)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k



# ---- the step transforms, --zero and --torch_export through the CLI ----


@pytest.mark.parametrize("extra", [
    ["--zero", "--zero1"], ["--zero", "--fsdp"],
    ["--zero", "--model_parallel", "2"],
    ["--zero", "--optimizer", "sgd_fused"],
    ["--zero", "--ckpt_backend", "orbax"],
    ["--zero", "--optimizer", "sgd_fused", "--ckpt_backend", "orbax"],
    ["--optimizer", "sgd_fused", "--zero1"],
    ["--torch_export", "--model", "vgg11"],
    ["--torch_export", "--model", "gpt_tiny", "--zero", "--zero1"],
    ["--model", "gpt_tiny", "--zero", "--optimizer", "sgd_fused"],
    ["--optimizer", "sgd_fused", "--fsdp"],
    ["--optimizer", "sgd_fused", "--model_parallel", "2"],
    ["--zero", "--fsdp", "--optimizer", "sgd_fused"],
    ["--zero1", "--optimizer", "sgd_fused", "--ckpt_backend", "orbax"],
])
def test_refusals_come_in_jax_order(tmp_path, extra):
    """A refused combination gets the JAX CLI's message (its first check
    that fires; the port's text drops the word "Pallas"), before any
    device, group or data work, ahead of the still-unported flags'
    rejection."""
    cli = _jax_cli()
    with pytest.raises((ValueError, SystemExit)) as ref:
        cli.main(cli.parser.parse_args(FLAGS + extra + [
            "--save_path", str(tmp_path / "jax")]))
    with pytest.raises(SystemExit) as got:
        port_main.main(FLAGS + extra + ["--device", "cpu", "--save_path",
                                        str(tmp_path / "run")])
    ref_msg = str(ref.value).replace("Pallas ", "")
    if "language model" in ref_msg:  # each CLI names its own LM trainer
        assert str(got.value).startswith(ref_msg.split(":")[0])
    else:
        assert str(got.value) == ref_msg
    assert not (tmp_path / "run").exists()


def test_transforms_match_jax_cli(tmp_path, same_init, capsys):
    """``--grad_accum 2 --clip_grad_norm 1.0 --ema 0.9 --remat`` through
    both CLIs, 2 epochs: the rows agree within 1e-4 (the test rows
    evaluate each CLI's EMA params), and the port's checkpoint carries
    ``ema_params``."""
    flags = FLAGS + ["--epochs", "2", "--grad_accum", "2",
                     "--clip_grad_norm", "1.0", "--ema", "0.9", "--remat"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cli = _jax_cli()
    cli.run_model(cli.parser.parse_args(flags + ["--save_path",
                                                 str(jax_dir)]))
    summary = port_main.main(flags + ["--device", "cpu", "--save_path",
                                      str(port_dir)])
    capsys.readouterr()
    for name in ("train.log", "test.log"):
        ours, ref = _rows(port_dir / name), _rows(jax_dir / name)
        assert [r[0] for r in ours] == [r[0] for r in ref] == [1.0, 2.0]
        for a, b in zip(ours, ref):
            assert abs(a[1] - b[1]) < TOL, (name, a, b)
            assert abs(a[2] - b[2]) < TOL, (name, a, b)
    payload = torch.load(port_dir / "model_2.pth", weights_only=True)
    assert "ema_params/linear/weight" in payload
    assert summary["steps"] == 4


def test_ema_evaluates_the_ema_params(tmp_path, capsys):
    """``--ema 0.5`` at a large lr: the test row's loss is the eval of
    the checkpoint's ``ema_params`` (with its BN stats), not of its
    training ``params``, which score another loss."""
    from pytorch_multiprocessing_distributed_tpu_torch.data import get_loader
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, make_eval_step)

    argv = BASE + ["--world_size", "1", "--device", "cpu", "--epochs", "1",
                   "--ema", "0.5", "--lr", "0.05", "--save_path",
                   str(tmp_path)]
    port_main.main(argv)
    capsys.readouterr()
    payload = torch.load(tmp_path / "model_1.pth", weights_only=True)
    args = port_main.build_parser().parse_args(argv)
    _, test_loader = get_loader(args, world_size=1, rank=0)
    model = get_model("res")
    state = create_train_state(model, ema=True)
    state.load_dict(payload)

    def eval_loss(params):
        with torch.no_grad():
            state.params.copy_(params)
        step, total, count = make_eval_step(model), 0.0, 0.0
        test_loader.set_epoch(1)
        for images, labels, valid in test_loader:
            m = step(state, torch.as_tensor(images), torch.as_tensor(labels),
                     torch.as_tensor(valid))
            total += float(m["loss_sum"])
            count += float(m["count"])
        return total / count

    trained = state.params.clone()
    row = _rows(tmp_path / "test.log")[0]
    assert abs(eval_loss(state.ema.clone()) - row[1]) < 1e-5
    assert abs(eval_loss(trained) - row[1]) > 1e-3


def test_torch_export_loads_into_the_jax_resnet(tmp_path, variables,
                                                capsys):
    """``--torch_export`` writes ``model_{epochs}.torch.pth``, the
    reference's ``state_dict``; the JAX package's
    ``load_torch_checkpoint`` reads it into the JAX ResNet-18, equal to
    the final params and BN stats of the port's checkpoint."""
    from pytorch_multiprocessing_distributed_tpu.utils.torch_interop import (
        load_torch_checkpoint)

    summary = port_main.main(FLAGS + ["--epochs", "1", "--device", "cpu",
                                      "--torch_export", "--save_path",
                                      str(tmp_path)])
    assert "Exported torch state_dict" in capsys.readouterr().out
    path = tmp_path / "model_1.torch.pth"
    sd = torch.load(path, weights_only=True)
    assert sd["bn1.num_batches_tracked"].dtype == torch.int64
    assert list(sd)[:6] == ["conv1.weight", "bn1.weight", "bn1.bias",
                            "bn1.running_mean", "bn1.running_var",
                            "bn1.num_batches_tracked"]
    params, stats = load_torch_checkpoint(str(path), *variables)
    carried = load_jax_resnet(jax.device_get(params), jax.device_get(stats))
    payload = torch.load(tmp_path / "model_1.pth", weights_only=True)
    for name, value in carried.items():
        group = ("batch_stats" if name.endswith(("running_mean",
                                                 "running_var"))
                 else "params")
        assert torch.equal(value, payload[f"{group}/"
                                          f"{name.replace('.', '/')}"]), name
    assert summary["steps"] == 2


def test_zero_checkpoint_resumes_in_a_plain_run(tmp_path):
    """``--zero`` on two gloo ranks: each rank holds half of the
    (padded) momenta, and its epoch-1 checkpoint (moments gathered)
    resumed by a plain run gives the plain run's rows, bit for bit."""
    flags = BASE + ["--device", "cpu", "--world_size", "2"]
    straight, split = tmp_path / "straight", tmp_path / "split"
    plain = port_main.main(flags + ["--epochs", "2", "--save_path",
                                    str(straight)])
    sharded = port_main.main(flags + ["--epochs", "1", "--zero",
                                      "--save_path", str(split)])
    resumed = port_main.main(flags + ["--epochs", "2", "--resume", "auto",
                                      "--save_path", str(split)])
    assert resumed["epoch_losses"] == plain["epoch_losses"][1:]
    for name in ("train.log", "test.log"):
        assert _rows(split / name) == _rows(straight / name)
    comm = sharded["static_comm_bytes"]
    assert sharded["opt_state_bytes"] == [comm["all_gather"]] * 2
    assert plain["opt_state_bytes"] == [4 * 4_903_242] * 2
    assert comm["reduce_scatter"] == 2 * comm["all_gather"] >= 4 * 4_903_242


# ---- the GSPMD placements (--zero1, --fsdp, --model_parallel) ----


@pytest.fixture(scope="module")
def gspmd_runs(tmp_path_factory):
    """The CLI on gloo ranks (one intra-op thread each), 32 images at
    batch 16 over 2 data replicas: the plain run for 2 epochs (both
    checkpoints kept, the export written), ``--fsdp`` the same way,
    ``--zero1`` and ``--model_parallel 2`` (4 ranks) for 1 epoch, and
    each of the plain and ``--fsdp`` runs resumed at epoch 2 from the
    other's ``model_1.pth``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    synth = os.environ.get("PMDT_SMALL_SYNTH")
    os.environ["PMDT_SMALL_SYNTH"] = "32"
    root = tmp_path_factory.mktemp("gspmd_cli")
    flags = BASE + ["--device", "cpu", "--world_size", "2"]
    two = ["--epochs", "2", "--save_every", "1", "--torch_export"]
    runs = {}
    try:
        for name, extra in (("plain", two), ("fsdp", two + ["--fsdp"]),
                            ("zero1", ["--epochs", "1", "--zero1"]),
                            ("model_parallel", ["--epochs", "1",
                                                "--model_parallel", "2"])):
            runs[name] = port_main.main(flags + extra + [
                "--save_path", str(root / name)])
        for name, src, extra in (("plain<fsdp", "fsdp", []),
                                 ("fsdp<plain", "plain", ["--fsdp"])):
            run = root / name
            run.mkdir()
            for f in ("model_1.pth", "model_1.pth.sha256"):
                (run / f).write_bytes((root / src / f).read_bytes())
            runs[name] = port_main.main(flags + extra + [
                "--epochs", "2", "--resume", "auto", "--save_path",
                str(run)])
    finally:
        torch.set_num_threads(threads)
        if synth is None:
            os.environ.pop("PMDT_SMALL_SYNTH", None)
        else:
            os.environ["PMDT_SMALL_SYNTH"] = synth
    return root, runs


def _assert_rows_close(got, ref, tol=1e-5):
    assert [r[0] for r in got] == [r[0] for r in ref]
    for a, b in zip(got, ref):
        assert abs(a[1] - b[1]) < tol and abs(a[2] - b[2]) < tol, (a, b)


@pytest.mark.parametrize("name,grid,ranks", [
    ("zero1", [2, 1], 2), ("fsdp", [2, 1], 2),
    ("model_parallel", [2, 2], 4)])
def test_gspmd_flags_train_on_gloo_ranks(gspmd_runs, name, grid, ranks):
    """``--zero1``, ``--fsdp`` and ``--model_parallel 2`` each train on a
    grid of gloo ranks (the model ranks of a replica read its rows):
    the first epoch's rows within 1e-5 of the plain run's at the same
    data degree, each rank holding its placement's bytes."""
    root, runs = gspmd_runs
    summary, plain = runs[name], runs["plain"]
    assert summary["grid"] == grid and summary["world_size"] == ranks
    for log in ("train.log", "test.log"):
        _assert_rows_close(_rows(root / name / log)[:1],
                           _rows(root / "plain" / log)[:1])
    full = plain["resident_bytes"][0]
    assert full["params"] == full["opt_state"] == 4 * 4_903_242
    mine = summary["resident_bytes"]
    assert len(mine) == ranks and all(r == mine[0] for r in mine)
    if name == "zero1":  # only the moments are sliced, over 2 replicas
        assert mine[0]["params"] == full["params"]
        assert mine[0]["opt_state"] < full["opt_state"] * 0.51
    else:  # everything sliced, over 2 ranks (the 10-class head's bias
        # divides, ResNet-18's stem Cin of 3 is never the split dim)
        for k in ("params", "opt_state", "batch_stats"):
            assert full[k] / 2 <= mine[0][k] < full[k] * 0.51, k


def test_fsdp_checkpoint_round_trips_with_plain_runs(gspmd_runs):
    """A ``--fsdp`` run's ``model_1.pth`` resumed by a plain run, and a
    plain run's resumed under ``--fsdp``: epoch 2 within 1e-5 of the
    straight plain run's, and the checkpoints are the plain format."""
    root, runs = gspmd_runs
    fsdp1 = torch.load(root / "fsdp" / "model_1.pth", weights_only=True)
    plain1 = torch.load(root / "plain" / "model_1.pth", weights_only=True)
    assert set(fsdp1) == set(plain1)
    for k, v in plain1.items():
        if isinstance(v, torch.Tensor):
            assert fsdp1[k].shape == v.shape, k
            torch.testing.assert_close(fsdp1[k].float(), v.float(),
                                       atol=1e-5, rtol=0, msg=k)
    for name in ("plain<fsdp", "fsdp<plain"):
        assert runs[name]["steps"] == 2
        for log in ("train.log", "test.log"):
            _assert_rows_close(_rows(root / name / log),
                               _rows(root / "plain" / log)[1:])
        got = torch.load(root / name / "model_2.pth", weights_only=True)
        ref = torch.load(root / "plain" / "model_2.pth", weights_only=True)
        for k, v in ref.items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(got[k].float(), v.float(),
                                           atol=1e-5, rtol=0, msg=(name, k))


def test_fsdp_torch_export_is_the_plain_export(gspmd_runs):
    """``--torch_export`` under ``--fsdp`` gathers the slices first: the
    same keys in the same order as the plain run's export, the values
    within 1e-5."""
    root, _ = gspmd_runs
    got = torch.load(root / "fsdp" / "model_2.torch.pth", weights_only=True)
    ref = torch.load(root / "plain" / "model_2.torch.pth", weights_only=True)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v, atol=1e-5, rtol=0, msg=k)
