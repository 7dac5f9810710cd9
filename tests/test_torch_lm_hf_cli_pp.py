"""The port's ``train_lm --parallel pp --degree 2 --hf_export --sample
--sample_beams`` on two gloo ranks against the JAX CLI on two of the
conftest's virtual devices (the cases: ``tests/lm_hf_cases.py``): rank
0 writes the whole params, the stages unstacked, as JAX's file within
1e-5, and prints JAX's best beam."""

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


def test_hf_export_and_beams_under_pp_match_jax_cli(tmp_path, monkeypatch,
                                                    capsys):
    init = cases.jax_init(tmp_path / "init.pt", gpt2=True)
    extra = ["--hf_export", "--parallel", "pp", "--degree", "2",
             "--sample", "4", "--sample_beams", "3"]
    jax_out, out, summary = cases.both(tmp_path, monkeypatch, capsys, extra,
                                       init, world=2)
    cases.same_export(tmp_path, summary)
    cases.same_sample(jax_out, out, summary)
