"""The port's ``train_lm --sample_beams`` against the JAX CLI on the CPU
(the cases: ``tests/lm_hf_cases.py``): the best beam printed equals
JAX's, from the CLIs' own init and from a GPT-2 file under ``--hf_init``
with ``--hf_export`` beside it (the files within 1e-5)."""

import pytest
import torch

import lm_hf_cases as cases


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for this file's torch work, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sample_beams_matches_jax_cli(tmp_path, monkeypatch, capsys):
    init = cases.jax_init(tmp_path / "init.pt", gpt2=False)
    jax_out, out, summary = cases.both(
        tmp_path, monkeypatch, capsys, ["--sample", "5", "--sample_beams",
                                        "3"], init)
    cases.same_sample(jax_out, out, summary)


def test_hf_init_beams_and_export_match_jax_cli(tmp_path, monkeypatch,
                                                capsys):
    hf = cases.hf_file(tmp_path / "tiny.hf.pth")
    jax_out, out, summary = cases.both(
        tmp_path, monkeypatch, capsys,
        ["--hf_init", hf, "--sample", "6", "--sample_beams", "4",
         "--hf_export"], None)
    cases.same_sample(jax_out, out, summary)
    cases.same_export(tmp_path, summary)
