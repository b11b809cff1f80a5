"""Build a CUDA source of this package into a shared library and load it.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout, at first use, then loaded with ``ctypes``.  The library's file
name carries a hash of the source and flags, so an edited source is
rebuilt and never mixed up with an old build.

Threads of one process may ask for the same library at once (a server's
scheduler thread and the main thread): one builds it while the others
wait, and ``nvcc`` writes into a file of its own thread and process, so a
library is installed whole or not at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import wraps
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


_locks: dict = {}                   # library path -> its build lock
_locks_guard = threading.Lock()


def _build_lock(path: Path) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(path, threading.Lock())


def once(fn):
    """``fn()`` computed by its first call and shared by every later one,
    from any thread: a thread that calls while another computes it waits
    for that result (``functools.cache`` would run ``fn`` in both)."""
    lock = threading.Lock()
    done = []

    @wraps(fn)
    def first():
        if not done:
            with lock:
                if not done:
                    done.append(fn())
        return done[0]
    return first


def build_library(source: Path, name: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``source`` (once per content) and load it.  Returns the
    library and a record of the build: the library path, the seconds
    ``nvcc`` took (0.0 when an earlier build was reused) and its
    output, which holds ``-Xptxas -v``'s register and memory counts.
    The output is kept beside the library (``<library>.log``) and read
    back when the build is reused, so the counts are there on every
    run.  Builds of one library are serialised; builds of different
    ones run in parallel."""
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    with _build_lock(out):
        return _build(source, out)


def _build(source: Path, out: Path) -> tuple[ctypes.CDLL, dict]:
    info = {"path": str(out), "seconds": 0.0, "log": ""}
    log = out.with_name(f"{out.name}.log")
    if out.exists() and log.exists():
        info["log"] = log.read_text()
    else:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - start
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source} (exit {proc.returncode}):\n"
                f"{info['log']}")
        tmp_log = tmp.with_name(f"{tmp.name}.log")
        tmp_log.write_text(info["log"])
        os.replace(tmp_log, log)        # the log first: a library found
        os.replace(tmp, out)            # later always has its log
    return ctypes.CDLL(str(out)), info
