"""The port's whole main path against the JAX package's pinned results.

``repro_torch.core.engine.simulate`` on the CPU must reproduce, bit for
bit, the comparable stats that the JAX package pinned:

  · tests/golden/determinism_tiny.json — TINY config, seq and vmap modes;
  · tests/golden/torch_port_rtx3080ti.json — the full-width RTX 3080 Ti
    config (80 SMs × 48 warps), vmap mode, max_cycles = 2^17.

Regenerate the second file from the JAX package with
    PYTHONPATH=src python tests/test_torch_engine.py --regen
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import repro.configs as JCONFIGS
from repro.configs import SHAPES as JSHAPES
from repro.sim.config import TINY as TINY_J
from repro.core import stats as JS
from repro.workloads.lm_traces import arch_workload as jarch_workload
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import stats as S
from repro_torch.core.batch import stack_kernels
from repro_torch.core.engine import run_workload_stacked, simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.launch import simulate as cli
from repro_torch.sim.config import RTX3080TI, TINY, split_config
from repro_torch.sim.state import init_state
from repro_torch.sim.workloads import resolve_workload
from repro_torch.workloads import arch_workload
from test_torch_trace import assert_packs_equal

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TINY_GOLDEN = os.path.join(HERE, "golden", "determinism_tiny.json")
FULL_GOLDEN = os.path.join(HERE, "golden", "torch_port_rtx3080ti.json")
TINY_MAX_CYCLES = 1 << 15          # as tests/test_determinism_matrix.py
FULL_MAX_CYCLES = 1 << 17
FULL_CASES = (("nn", 0.5), ("syrk", 0.16))


@pytest.fixture(autouse=True)
def _one_thread():
    """The simulator's tensors are tiny; torch's intra-op threads only add
    contention between test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_port(bench, scale, cfg, mode, max_cycles):
    out = S.finalize(simulate(resolve_workload(bench, scale), cfg,
                              make_sm_runner(cfg, mode),
                              max_cycles=max_cycles, device="cpu"))
    assert out["timeouts"] == 0
    return S.comparable(out)


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("bench,scale,mode", [
    ("myocyte", 1.0, "seq"), ("myocyte", 1.0, "vmap"),
    ("zoo:mixed", 0.03, "vmap"),
    ("trace:gather_chain", 1.0, "vmap"), ("trace:gather_chain", 1.0, "seq")])
def test_tiny_matches_golden(bench, scale, mode):
    got = run_port(bench, scale, TINY, mode, TINY_MAX_CYCLES)
    assert got == load(TINY_GOLDEN)[f"{bench}@{scale}"]


def test_full_width_nn_matches_pinned():
    got = run_port("nn", 0.5, RTX3080TI, "vmap", FULL_MAX_CYCLES)
    assert got == load(FULL_GOLDEN)["nn@0.5"]


def test_full_golden_is_comparable_only():
    golden = load(FULL_GOLDEN)
    assert set(golden) == {f"{b}@{s}" for b, s in FULL_CASES}
    for stats in golden.values():
        assert S.comparable(stats) == stats


def test_padding_kernels_are_inert():
    """Empty padding kernels and NOP slots change nothing, with and
    without early exit; every kernel of the workload still runs."""
    w = resolve_workload("zoo:reduction_tree", 0.02)
    runner = make_sm_runner(TINY, "vmap")
    want = S.finalize(simulate(w, TINY, runner, device="cpu"))
    scfg, dyn = split_config(TINY, device="cpu")
    packs = [k.pack("cpu") for k in w.kernels]
    n_instr = max(int(p["ops"].shape[0]) for p in packs) + 5
    stacked = stack_kernels(packs, n_instr=n_instr, n_kernels=len(packs) + 2)
    for early_exit in (True, False):
        # one lane
        st = run_workload_stacked(
            init_state(scfg, "cpu"), {f: v[None] for f, v in stacked.items()},
            scfg, dyn.map(lambda x: x[None]), runner, early_exit=early_exit)
        got = S.finalize(S.take_lane(st, 0))
        assert S.comparable(got) == S.comparable(want)
        assert got["timeouts"] == 0
    assert want["ctas_launched"] == sum(k.n_ctas for k in w.kernels)


def test_timeouts_are_counted():
    out = S.finalize(simulate(resolve_workload("myocyte", 1.0), TINY,
                              make_sm_runner(TINY, "vmap"), max_cycles=64,
                              device="cpu"))
    assert out["timeouts"] == 1 and out["timeout"]
    assert out["cycles"] == 64


def test_to_jsonable_matches_reference():
    out = S.finalize(simulate(resolve_workload("myocyte", 1.0), TINY,
                              make_sm_runner(TINY, "vmap"), max_cycles=64,
                              device="cpu"))
    payload = dict(out, tensor=torch.arange(3), nested=(1, 2.5, None))
    got = S.to_jsonable(payload)
    assert json.loads(json.dumps(got)) == got
    assert got["issued_per_sm"] == out["issued_per_sm"].tolist()
    assert got["tensor"] == [0, 1, 2]
    del payload["tensor"]
    assert JS.to_jsonable(payload) == S.to_jsonable(payload)


def test_simulate_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate(resolve_workload("myocyte", 1.0), TINY,
                 make_sm_runner(TINY, "vmap"))


def test_shard_mode_is_refused_by_name():
    """Without a mesh that has an 'sm' axis, mode='shard' raises the
    reference's ValueError."""
    from repro.core.parallel import make_sm_runner as jrunner
    from repro_torch.core.distribute import make_mesh
    with pytest.raises(ValueError) as want:
        jrunner(TINY_J, "shard")
    for mesh in (None, _OneAxis("cfg")):
        with pytest.raises(ValueError) as got:
            make_sm_runner(TINY, "shard", mesh)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible"):
        make_sm_runner(TINY, "shard", make_mesh(1, 3, device="cpu"))


class _OneAxis:
    def __init__(self, name):
        self.axis_names = (name,)


@pytest.mark.parametrize("bench,n_dev", [("trace:gather_chain", 2),
                                         ("trace:gather_chain", 4)])
def test_shard_mode_runs_and_equals_golden(bench, n_dev):
    """The shard SM runner (blocks over a CPU mesh's 'sm' axis, the serial
    region on the whole arrays) through ``simulate``: the golden stats."""
    from repro_torch.launch.mesh import make_host_mesh
    with open(TINY_GOLDEN) as f:
        want = json.load(f)[f"{bench}@1.0"]
    runner = make_sm_runner(TINY, "shard", make_host_mesh(n_dev,
                                                          device="cpu"))
    got = S.finalize(simulate(resolve_workload(bench, 1.0), TINY, runner,
                              max_cycles=TINY_MAX_CYCLES, device="cpu"))
    assert S.comparable(got) == want and got["timeouts"] == 0


def test_cli_prints_comparable_stats(capsys):
    cli.main(["--workload", "nn", "--scale", "0.02", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    printed = json.loads("\n".join(lines[:-1]))
    assert printed == run_port("nn", 0.02, RTX3080TI, "vmap", 1 << 17)
    assert lines[-1].startswith(f"[simulate] nn: {printed['cycles']} GPU "
                                "cycles, ipc=")


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", JCONFIGS.list_archs())
def test_arch_workload_pack_equal(arch, shape):
    """Every arch x shape cell's LM-derived workload packs as the JAX
    package's does."""
    assert_packs_equal(
        jarch_workload(JCONFIGS.get_config(arch), JSHAPES[shape]),
        arch_workload(get_config(arch), SHAPES[shape]))


def test_cli_runs_arch(capsys):
    cli.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--max-cycles",
              "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    printed = json.loads("\n".join(lines[:-1]))
    w = arch_workload(get_config("rwkv6-1.6b"), SHAPES["train_4k"])
    out = S.finalize(simulate(w, RTX3080TI, make_sm_runner(RTX3080TI, "vmap"),
                              max_cycles=32, device="cpu"))
    assert printed == S.comparable(out)
    # five kernels, each cut at 32 cycles
    assert out["timeouts"] == len(w.kernels) == 5
    assert lines[-1].startswith("[simulate] rwkv6-1.6b__train_4k: "
                                f"{printed['cycles']} GPU cycles, ipc=")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
    assert int(proc.stdout.split()[1]) >= 15


def _regen():
    from repro.core.engine import simulate as jsimulate
    from repro.core.parallel import make_sm_runner as jrunner
    from repro.sim.config import RTX3080TI as JRTX
    from repro.workloads import make_workload

    golden = {}
    for bench, scale in FULL_CASES:
        out = JS.finalize(jsimulate(make_workload(bench, scale=scale), JRTX,
                                    jrunner(JRTX, "vmap"),
                                    max_cycles=FULL_MAX_CYCLES))
        assert out["timeouts"] == 0, (bench, out["timeouts"])
        golden[f"{bench}@{scale}"] = JS.comparable(out)
    with open(FULL_GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
    print(f"wrote {FULL_GOLDEN}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
