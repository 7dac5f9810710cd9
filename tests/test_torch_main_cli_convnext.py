"""The port's image CLI on the ImageNet route with ConvNeXt-T under
LAMB against the JAX package's ``main.py`` (the set and tolerances:
``tests/main_cli_cases.py``; the ResNet-50 case of the same test is
``tests/test_torch_main_cli_imagenet.py``). Moved out of
``tests/test_torch_main_cli.py`` whole, with its case's id."""

import pytest

from pytorch_multiprocessing_distributed_tpu_torch import main as port_main
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    load_jax_resnet)

from main_cli_cases import (  # noqa: F401  (fixtures, by name)
    IMAGENET, TRAJ_TOL, _jax_cli, _reverse_jax_batches, _rows,
    _tiny_synthetic, _torch_cpu_state, carried_init)



@pytest.mark.parametrize("name,flags", [
    ("convnext_t", ["--model", "convnext_t", "--optimizer", "lamb",
                    "--lr", "0.00001"]),
], ids=["convnext_t-flags1"])
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
