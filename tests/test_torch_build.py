"""The kernels' first build and load from several threads at once
(kernels/build.py), on the CPU with ``nvcc`` stubbed.

A server runs its batches on a scheduler thread while another thread may
reach the same kernel first.  One library must then be built once and
installed whole: the build of one library is serialised, ``nvcc`` writes
into a file of its own thread, and a kernel's cached launcher runs its
build once however many threads ask for it first.
"""
import _ctypes
import os
import sys
import threading
import time

from repro_torch.kernels import build

# a shared object that loads in this process: what the stub installs
LIBRARY = _ctypes.__file__

STUB = f"""#!{sys.executable}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({{marker!r}}, "a") as f:
    f.write(out + "\\n")
print("ptxas info    : Used 40 registers, 0 bytes spill stores")
data = open({LIBRARY!r}, "rb").read()
with open(out, "wb") as f:          # slowly, so a second writer would
    for i in range(0, len(data), len(data) // 8 + 1):    # interleave
        f.write(data[i:i + len(data) // 8 + 1])
        f.flush()
        time.sleep(0.05)
"""


def _together(n, fn):
    """``fn()`` from ``n`` threads released at once; their results."""
    barrier = threading.Barrier(n)
    results = [None] * n

    def run(i):
        barrier.wait()
        results[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return results


def test_concurrent_first_build_installs_one_intact_library(tmp_path,
                                                            monkeypatch):
    marker = tmp_path / "nvcc_runs.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(marker=str(marker)))
    stub.chmod(0o755)
    source = tmp_path / "twin.cu"
    source.write_text("// a kernel source\n")
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")

    results = _together(4, lambda: build.build_library(source, "twin"))

    assert len(marker.read_text().splitlines()) == 1     # one nvcc run
    paths = {info["path"] for _, info in results}
    assert len(paths) == 1
    (path,) = paths
    with open(path, "rb") as a, open(LIBRARY, "rb") as b:
        assert a.read() == b.read()                     # installed whole
    assert sorted(info["seconds"] > 0 for _, info in results) == \
        [False, False, False, True]
    assert all(lib._name == path for lib, _ in results)
    name = os.path.basename(path)
    assert sorted(os.listdir(tmp_path / "kernels")) == [name, name + ".log"]


def test_reused_build_returns_its_ptxas_log(tmp_path, monkeypatch):
    """A library built by an earlier run comes back with the ``-Xptxas
    -v`` output of its build, so a check of registers and spills reads
    the same lines on a first and a later run; a library without its log
    is built again."""
    marker = tmp_path / "nvcc_runs.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(marker=str(marker)))
    stub.chmod(0o755)
    source = tmp_path / "kept.cu"
    source.write_text("// a kernel source\n")
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")

    _, first = build.build_library(source, "kept")
    _, again = build.build_library(source, "kept")
    assert first["seconds"] > 0 and again["seconds"] == 0.0
    assert "Used 40 registers" in first["log"]
    assert again["log"] == first["log"]
    assert len(marker.read_text().splitlines()) == 1

    os.remove(first["path"] + ".log")
    _, rebuilt = build.build_library(source, "kept")
    assert rebuilt["seconds"] > 0 and rebuilt["log"] == first["log"]
    assert len(marker.read_text().splitlines()) == 2


def test_once_runs_its_function_once_across_threads():
    """More threads than cores, switching as often as the interpreter
    allows: the wrapped function still runs once."""
    calls = []

    @build.once
    def launcher():
        calls.append(threading.get_ident())
        time.sleep(0.1)
        return object()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = _together(max(16, 2 * (os.cpu_count() or 1)), launcher)
    finally:
        sys.setswitchinterval(interval)
    assert len(calls) == 1
    assert all(r is results[0] for r in results)
    assert launcher() is results[0]


def test_every_kernel_launcher_is_built_once():
    """Each kernel module's launcher is wrapped by ``build.once``."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.sm_issue import kernel as si
    from repro_torch.kernels.sm_quantum import kernel as sq
    from repro_torch.kernels.wkv6 import kernel as wk
    first = build.once(lambda: None).__code__
    for mod in (fa, si, sq, wk):
        assert mod._launcher.__code__ is first, mod.__name__
        assert mod._launcher.__wrapped__.__module__ == mod.__name__
    for mod in (fa, wk):          # the backward kernels' launchers
        assert mod._bwd_launcher.__code__ is first, mod.__name__
        assert mod._bwd_launcher.__wrapped__.__module__ == mod.__name__
