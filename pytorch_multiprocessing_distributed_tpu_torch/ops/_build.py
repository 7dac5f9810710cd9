"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` alone into ``_build/lib<name>-<hash>.so`` inside the package
(listed in ``.gitignore``); the hash covers the source and the flags,
so an edited source never loads a stale library. No PyTorch headers are
compiled: a build takes seconds, not minutes. :func:`build_all` starts
one ``nvcc`` per source at once (what ``chip_smoke.py`` calls before it
times anything).

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels build only on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    ``(target, temporary output, process or None)``."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> str:
    """Wait for a build started by :func:`_start`; returns nvcc's
    output (the ``-Xptxas -v`` register/shared-memory report)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a reader sees all or none
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every source in ``csrc/`` (or those ``names``) in parallel
    (one ``nvcc`` each, all started together); returns each build's
    compiler report."""
    with _lock:
        started = {name: _start(name) for name in (names or sources())}
        return {name: _finish(name, *started[name]) for name in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, tmp, proc = _start(name)
            _finish(name, target, tmp, proc)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


class PtxasEntry(NamedTuple):
    """One function of an ``-Xptxas -v`` report."""

    name: str  # the mangled name
    registers: int
    spill_stores: int  # bytes
    spill_loads: int  # bytes
    serialised: bool  # ptxas serialised its wgmma (warning C7512)


def ptxas_entries(log: str) -> List[PtxasEntry]:
    """Every function of an ``-Xptxas -v`` report (what :func:`build_all`
    returns) that names its registers, in the report's order."""
    serial = set(re.findall(r"C7512\).*'(\S+)'", log))
    found, name, spills = [], None, None
    for line in log.splitlines():
        prop = re.search(r"Function properties for (\S+)", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        used = re.search(r"Used (\d+) registers", line)
        if prop:
            name, spills = prop.group(1), None
        elif spill and name:
            spills = (int(spill.group(1)), int(spill.group(2)))
        elif used and name and spills:
            found.append(PtxasEntry(name, int(used.group(1)), *spills,
                                    name in serial))
            name = None
    return found
