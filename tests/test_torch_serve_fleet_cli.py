"""``serve_lm --replicas``, ``--role`` and ``--router_port`` against the
JAX CLI on the CPU, both in this process on the same gpt_tiny weights
(JAX ``init_params(gpt_tiny, 0)``, an ``.npz`` for the port and a
msgpack checkpoint for JAX): the transcripts and the ``metrics:`` line's
counts of ``--replicas 2``, ``--role split`` and ``--role
prefill,decode,decode`` (paged) are equal, and so is every
refusal message; a fleet under ``--tp 2`` is refused by name; the
router's stats server answers ``/healthz`` and ``/metrics`` while a
``--stdin`` fleet serves. ``--router_port 0`` is off, as
in JAX, so that test binds a free port."""

import contextlib
import io
import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import serve_lm as jax_serve_lm
from pytorch_multiprocessing_distributed_tpu_torch import serve_lm

from cli_procs import free_port
from serving_heal_cases import tiny_ckpts

BASE = ["--model", "gpt_tiny", "--synthetic", "5", "--max_slots", "2",
        "--s_max", "64", "--decode_buckets", "off",
        "--max_new_tokens", "8", "--seed", "3",
        "--quiet"]
FLEETS = {
    "both": ["--replicas", "2"],
    "split": ["--replicas", "2", "--role", "split"],
    "list": ["--replicas", "3", "--role", "prefill,decode,decode",
             "--kv_layout", "paged", "--page_size", "8"],
}
# the metrics line's counts (timings and per-replica goodput apart)
COUNTS = ("requests_completed", "tokens_generated", "decode_tokens",
          "requests_failed", "requests_shed", "requests_redelivered",
          "redelivery_replayed_tokens", "fleet_requests_redelivered",
          "fleet_prefix_routed", "fleet_steals", "fleet_transfers_routed",
          "fleet_transfers_withdrawn", "fleet_transfer_bytes",
          "fleet_requests_shed", "fleet_replicas", "fleet_replicas_dead",
          "fleet_pending", "fleet_transfers_pending",
          "fleet_admit_window_total", "rejected", "replicas",
          "replicas_alive", "fleet_state", "page_holds")


def _lines(text):
    """(transcripts {uid: tokens}, the metrics dict)."""
    tokens = dict(re.findall(r"^req=(\S+) tokens=(\[.*\])$", text, re.M))
    metrics = [line for line in text.splitlines()
               if line.startswith("metrics: ")]
    assert len(metrics) == 1
    return tokens, json.loads(metrics[0][len("metrics: "):])


def _jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_serve_lm.main()
    return buf.getvalue()


def _port_cli(argv):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            serve_lm.main(["--device", "cpu", *argv])
    finally:
        torch.set_num_threads(threads)
    return buf.getvalue()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return tiny_ckpts(tmp_path_factory.mktemp("fleet_cli"))


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_fleet_matches_jax_cli(ckpts, fleet, monkeypatch):
    npz, msgpack = ckpts
    argv = BASE[:-1] + FLEETS[fleet]  # streams printed
    want, jsnap = _lines(_jax_cli(argv + ["--ckpt", msgpack], monkeypatch))
    got, snap = _lines(_port_cli(argv + ["--ckpt", npz]))
    assert len(got) == 5 and got == want
    for key in COUNTS:
        assert snap[key] == jsnap[key], key
    assert set(snap["per_replica"]) == set(jsnap["per_replica"])
    assert snap["fleet_state"] == "DEAD"  # drained
    # the decode replicas decoded, the prefill replica did not
    roles = snap["replicas_roles"]
    for rid, passes in snap["decode_passes_by_k_per_replica"].items():
        assert bool(passes) == (roles[rid] != "prefill")


REFUSALS = [["--replicas", "0", "--role", "split"],
            ["--role", "split"],
            ["--replicas", "3", "--role", "prefill,decode"],
            ["--replicas", "2", "--role", "prefill,prefill"]]


@pytest.mark.parametrize("argv", REFUSALS)
def test_refusals_match_jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", "--random_init",
                                      "--model", "gpt_tiny", *argv])
    with pytest.raises(SystemExit) as jerr:
        jax_serve_lm.main()
    with pytest.raises(SystemExit) as err:
        serve_lm.main(["--device", "cpu", "--random_init", "--model",
                       "gpt_tiny", *argv])
    assert str(err.value) == str(jerr.value) and str(err.value)


def test_fleet_under_tp_is_refused():
    with pytest.raises(SystemExit, match=(
            r"^--replicas/--role under --tp 2 is not ported to PyTorch yet "
            r"\(ROADMAP.md, 'Port: serving features still to port'\)")):
        serve_lm.main(["--device", "cpu", "--random_init", "--tp", "2",
                       "--replicas", "2"])


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return 0, ""


def test_router_port_answers_healthz_and_metrics():
    """A thread reads the routes while the fleet serves in this
    process (its source kept open until the scrape is done)."""
    port, got, scraped = free_port(), {}, threading.Event()

    def scrape():
        deadline = time.time() + 60
        while time.time() < deadline and "/healthz" not in got:
            status, body = _get(port, "/healthz")
            if status == 200:
                got["/healthz"] = body
                got["/metrics"] = _get(port, "/metrics")
            time.sleep(0.02)
        scraped.set()

    def source():
        yield [1, 2, 3], 4
        scraped.wait(60)  # the fleet stays up until the scrape is done

    threading.Thread(target=scrape, daemon=True).start()
    real = serve_lm._load_requests
    serve_lm._load_requests = lambda args, vocab, skipped: source()
    try:
        _port_cli(["--model", "gpt_tiny", "--random_init", "--replicas",
                   "2", "--max_new_tokens", "4", "--stdin", "--quiet",
                   "--router_port", str(port)])
    finally:
        serve_lm._load_requests = real
    health = json.loads(got["/healthz"])
    assert health["state_name"] == "READY"
    assert set(health["replicas"]) == {"r0", "r1"}
    status, text = got["/metrics"]
    assert status == 200 and "pmdt_fleet_fleet_replicas 2" in text
