"""Build the port's CUDA sources (`csrc/*.cu`) on first use.

Each source compiles with nvcc, on its own, into a shared library with a
plain C interface that `ctypes` loads — no PyTorch headers, so a build
takes seconds. Outputs go to `build/` beside this file (git-ignored),
named by a hash of the source, every shared header (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. A failed build raises; nothing falls back.
`-Xptxas -v` makes nvcc report each kernel's registers, shared memory and
spills; `build()` returns that report (chip_smoke.py prints it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float
    log: str          # nvcc's stderr (the ptxas resource report); "" if reused


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        f"nvcc not found (looked in {cand} and on PATH): the port's CUDA "
        f"kernels are built from source on the machine with the card")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> List[BuildResult]:
    """Compile the named sources, all nvcc processes started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = [], []
    for name in names:
        out = _target(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    for name, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu (rc "
                               f"{proc.returncode}):\n{stdout}{stderr}")
        os.replace(tmp, out)   # atomic publish: readers never see a partial .so
        results.append(BuildResult(name, out, seconds, stderr))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/{name}.cu`, built first if needed."""
    if name not in _LOADED:
        (res,) = build([name])
        _LOADED[name] = ctypes.CDLL(str(res.path))
    return _LOADED[name]


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))

