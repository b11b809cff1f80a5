"""Build a CUDA source of this package into a shared library and load it.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout, at first use, then loaded with ``ctypes``.  The library's file
name carries a hash of the source and flags, so an edited source is
rebuilt and never mixed up with an old build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_library(source: Path, name: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``source`` (once per content) and load it.  Returns the
    library and a record of the build: the library path, the seconds
    ``nvcc`` took (0.0 when an earlier build was reused) and its
    output, which holds ``-Xptxas -v``'s register and memory counts."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    info = {"path": str(out), "seconds": 0.0, "log": ""}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - start
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source} (exit {proc.returncode}):\n"
                f"{info['log']}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out)), info
