"""The port's image CLI under the GSPMD placements (``--zero1``,
``--fsdp``, ``--model_parallel``) on gloo ranks, against its plain
runs. Moved out of ``tests/test_torch_main_cli.py`` whole."""

import os

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch import main as port_main

from main_cli_cases import (  # noqa: F401  (fixtures, by name)
    BASE, _rows, _torch_cpu_state)



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
