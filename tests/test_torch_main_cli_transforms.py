"""The port's image CLI with the step transforms, ``--zero`` and
``--torch_export`` against the JAX package's ``main.py`` and the
reference's ``state_dict``. Moved out of ``tests/test_torch_main_cli.py``
whole."""

import jax
import torch

from pytorch_multiprocessing_distributed_tpu_torch import main as port_main
from pytorch_multiprocessing_distributed_tpu_torch.models import (
    load_jax_resnet)

from main_cli_cases import (  # noqa: F401  (fixtures, by name)
    BASE, FLAGS, TOL, _jax_cli, _rows, _torch_cpu_state, same_init,
    variables)



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
