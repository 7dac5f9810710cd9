"""The port's ``train_lm --hf_export`` and ``--hf_init`` against the JAX
CLI on the CPU (the cases: ``tests/lm_hf_cases.py``): the exported
files agree tensor for tensor within 1e-5, a run started from a GPT-2
file prints JAX's greedy sample, and every refusal of the HF and beam
flags is the JAX CLI's, word for word, in its order, before anything is
written."""

import pytest
import torch

from pytorch_multiprocessing_distributed_tpu_torch import train_lm

import lm_hf_cases as cases


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hf")
    return dict(init=cases.jax_init(tmp / "init.pt", gpt2=True),
                hf=cases.hf_file(tmp / "tiny.hf.pth"),
                wide=cases.hf_file(tmp / "wide.hf.pth", mlp_dim=256))


def test_hf_export_matches_jax_cli(tmp_path, monkeypatch, capsys, files):
    jax_out, out, summary = cases.both(tmp_path, monkeypatch, capsys,
                                       ["--hf_export"], files["init"])
    cases.same_export(tmp_path, summary)
    assert f"HF export: {tmp_path / 'port' / 'model_1.hf.pth'}" in out
    assert "HF export: " in jax_out


def test_hf_init_greedy_sample_matches_jax_cli(tmp_path, monkeypatch,
                                               capsys, files):
    """Both CLIs start from the same GPT-2 file: the same rows and the
    same greedy sample."""
    jax_out, out, summary = cases.both(
        tmp_path, monkeypatch, capsys,
        ["--hf_init", files["hf"], "--sample", "6"], files["init"])
    cases.same_sample(jax_out, out, summary)


@pytest.mark.parametrize("case", [
    "moe_first", "resume", "geometry", "beams_no_sample",
    "beams_past_vocab", "beams_negative", "geometry_before_beams"])
def test_refusals_match_jax_cli(tmp_path, monkeypatch, files, case):
    extra = {
        "moe_first": ["--n_experts", "2", "--resume", "auto", "--hf_init",
                      files["wide"]],
        "resume": ["--resume", "auto", "--hf_init", files["wide"]],
        "geometry": ["--hf_init", files["wide"]],
        "beams_no_sample": ["--sample_beams", "2"],
        "beams_past_vocab": ["--sample", "4", "--sample_beams", "258"],
        "beams_negative": ["--sample", "4", "--sample_beams", "-1"],
        "geometry_before_beams": ["--hf_init", files["wide"],
                                  "--sample_beams", "2"],
    }[case]
    cli = cases.jax_cli(monkeypatch)
    with pytest.raises(SystemExit) as theirs:
        cli.main(cli.parser.parse_args(cases.FLAGS + extra + [
            "--save_path", str(tmp_path / "jax")]))
    cases.cut_model(monkeypatch)
    with pytest.raises(SystemExit) as ours:
        train_lm.main(cases.FLAGS + extra + [
            "--device", "cpu", "--save_path", str(tmp_path / "port")])
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith("--")
    assert not (tmp_path / "port").exists()
