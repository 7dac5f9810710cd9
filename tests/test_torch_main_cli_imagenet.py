"""The port's image CLI on the ImageNet route (ResNet-50 under SGD)
and LAMB, and its refusals, against the JAX package's ``main.py``
(the set and tolerances: ``tests/main_cli_cases.py``); ConvNeXt-T under
LAMB is ``tests/test_torch_main_cli_convnext.py``. Moved out of
``tests/test_torch_main_cli.py`` whole."""

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch import main as port_main
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    load_jax_resnet)

from main_cli_cases import (  # noqa: F401  (fixtures, by name)
    FLAGS, IMAGENET, TRAJ_TOL, _jax_cli, _reverse_jax_batches, _rows,
    _tiny_synthetic, _torch_cpu_state, carried_init)



@pytest.mark.parametrize("name,flags", [
    ("resnet50", ["--model", "resnet50", "--lr", "1e-12"]),
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
