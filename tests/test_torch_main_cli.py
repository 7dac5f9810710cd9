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

import re

import numpy as np
import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch import (
    CudaUnavailableError)
from pytorch_multiprocessing_distributed_tpu_torch import main as port_main

from main_cli_cases import (  # noqa: F401  (fixtures, by name)
    BASE, FLAGS, TOL, _jax_cli, _rows, _torch_cpu_state, same_init,
    variables)



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


@pytest.mark.parametrize("extra", [["--optimizer", "lamb"],
                                   ["--dataset", "imagenet"],
                                   ["--grad_accum", "2"],
                                   ["--clip_grad_norm", "1.0"],
                                   ["--ema", "0.999"], ["--remat"],
                                   ["--zero"], ["--torch_export"],
                                   ["--zero1"], ["--fsdp"],
                                   ["--model_parallel", "2"],
                                   ["--model_parallel", "2", "--zero1",
                                    "--optimizer", "lamb"],
                                   ["--stats_port", "9137"],
                                   ["--trace_out", "t.json"],
                                   ["--events_out", "e.jsonl"],
                                   ["--flight_path", "f.jsonl"]])
def test_ported_flags_are_accepted(extra):
    """The flags this port has taken out of the rejected list pass the
    CLI's checks (their runs are held against JAX below, and the
    observability flags' in tests/test_torch_scope_cli.py)."""
    args = port_main.build_parser().parse_args(FLAGS + extra)
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
