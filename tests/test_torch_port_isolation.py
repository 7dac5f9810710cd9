"""The PyTorch port stands alone: it imports neither ``jax``/``flax`` nor
anything of the JAX package, statically (an AST scan of every source)
and at run time (a fresh interpreter importing every module)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = "pytorch_multiprocessing_distributed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_multiprocessing_distributed_tpu")


def _port_sources():
    return sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]


def _absolute_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_in_port_sources():
    offenders = []
    for path in _port_sources():
        for name in _absolute_imports(path):
            if name.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
    assert len(_port_sources()) > 10  # the scan saw the package


def test_importing_the_whole_port_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
import {PORT} as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r})
for name in ("parallel.ring_attention", "parallel.ulysses",
             "parallel.mesh", "ops.losses", "parallel.pipeline",
             "parallel.gpt_pipeline", "ops.moe"):
    assert "{PORT}." + name in sys.modules, name
print("modules", len([m for m in sys.modules if m.startswith("{PORT}")]))
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 37  # every module of the port


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result where it cannot
    run: on a machine without a card (here), or from a directory that
    holds it and nothing else of the repo."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
