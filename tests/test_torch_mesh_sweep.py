"""2-D ('cfg', 'sm') mesh distribution (core/distribute.py) on a mesh
that puts the CPU at every position: the port's counterpart of
tests/test_mesh_sweep.py.

  · ``grid_sweep`` at 1×1, 2×1, 1×2 and 2×2 equals the port's no-mesh
    grid and the JAX package's no-mesh grid (tests/test_torch_grid.py's
    fixture), lane for lane on ``comparable()``, ``timeouts`` and
    ``total_cycles``; a 'cfg' axis of 2 takes the fixture's first two
    configs;
  · a grid holding a real-trace workload, on 2×2;
  · ``sweep`` on 2×2 with the per-cycle exchange;
  · ``check_mesh``'s and ``make_mesh``'s rejections, with the reference's
    messages where it has them, and where a mesh run's results land;
  · ``launch/dse.py`` and ``launch/zoo.py`` with ``--mesh 2 2 --check``,
    their wording and manifests; ``pair_sweep`` and ``SimService``
    refuse a mesh as the reference's do.
"""
import dataclasses
import json
import os

import pytest
import torch

import repro.core.distribute as JD
import repro.core.plan as JPLAN
import repro.core.stats as JS
from repro_torch.core import stats as S
from repro_torch.core import telemetry as T
from repro_torch.core.distribute import (CFG_AXIS, SM_AXIS, Mesh, check_mesh,
                                         make_mesh, mesh_device, state_specs)
from repro_torch.core.plan import RunPlan
from repro_torch.core.service import SimService
from repro_torch.core.sweep import grid_sweep, pair_sweep, sweep
from repro_torch.launch import dse, zoo
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sim.config import TINY, static_part
from repro_torch.sim.workloads import resolve_workload
# jax_grid: the fixture of the JAX package's no-mesh grid
from test_torch_grid import HERE, MAX_CYCLES, NAMES, OVERRIDES, jax_grid, scale

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def signature(stats):
    return dict(S.comparable(stats), timeouts=stats["timeouts"])


def jsignature(stats):
    return dict(JS.comparable(stats), timeouts=stats["timeouts"])


def port_grid(names, overrides, mesh=None, **plan):
    return grid_sweep([resolve_workload(n, scale(n)) for n in names],
                      [dataclasses.replace(TINY, **o) for o in overrides],
                      plan=RunPlan(max_cycles=MAX_CYCLES, mesh=mesh, **plan),
                      device="cpu")


@pytest.fixture(scope="module")
def nomesh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return port_grid(NAMES, OVERRIDES)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_grid_mesh_equals_nomesh_and_jax(jax_grid, nomesh, shape):
    n_cfg, n_sm = shape
    n_c = 2 if n_cfg == 2 else len(OVERRIDES)
    grid = port_grid(NAMES, OVERRIDES[:n_c],
                     make_mesh(n_cfg, n_sm, device="cpu"))
    assert grid.state["ctrl"]["cycle"].shape == (len(NAMES), n_c)
    assert grid.state["warp"]["pc"].shape[:3] == (len(NAMES), n_c, TINY.n_sm)
    for w in range(len(NAMES)):
        for c in range(n_c):
            got = signature(grid.stats[w][c])
            assert got == signature(nomesh.stats[w][c]), (NAMES[w], c)
            assert got == jsignature(jax_grid.stats[w][c]), (NAMES[w], c)
            assert int(grid.lane_state(w, c)["ctrl"]["total_cycles"]) == \
                int(jax_grid.lane_state(w, c)["ctrl"]["total_cycles"])
    assert any(s["cycles"] > 0 for row in grid.stats for s in row)


def test_trace_workload_grid_on_2x2_mesh():
    """A grid holding a trace-derived workload (the full ingest path) next
    to a synthetic one: on 2×2 equal to the no-mesh run."""
    names = ("trace:gather_chain", "zoo:mixed")
    over = [dict(scheduler="lrr"), dict(l2_lat=64, dram_row_penalty=48)]
    ref = port_grid(names, over)
    got = port_grid(names, over, make_mesh(2, 2, device="cpu"))
    assert any(s["cycles"] > 0 for row in ref.stats for s in row)
    assert [[signature(s) for s in row] for row in got.stats] == \
        [[signature(s) for s in row] for row in ref.stats]


def test_sweep_on_2x2_with_cycle_exchange():
    w = resolve_workload("trace:gather_chain")
    cfgs = [dataclasses.replace(TINY, **o) for o in OVERRIDES[:2]]
    ref = sweep(w, cfgs, plan=RunPlan(max_cycles=MAX_CYCLES), device="cpu")
    got = sweep(w, cfgs, plan=RunPlan(max_cycles=MAX_CYCLES,
                                      mesh=make_mesh(2, 2, device="cpu"),
                                      exchange="cycle"), device="cpu")
    assert [signature(s) for s in got.stats] == \
        [signature(s) for s in ref.stats]
    assert got.state["ctrl"]["cycle"].shape == (2,)


class _StubMesh:
    """check_mesh only reads axis_names/shape."""

    def __init__(self, n_cfg, n_sm, names=("cfg", "sm")):
        self.axis_names = names
        self.shape = {names[0]: n_cfg, names[-1]: n_sm}


@pytest.mark.parametrize("args", [
    ((3, 1), 4), ((1, 3), 3), ((2, 2, ("data", "model")), 4)])
def test_check_mesh_rejects_bad_shapes(args):
    (stub, n_lanes) = args
    scfg = static_part(TINY)                  # n_sm = 8
    check_mesh(_StubMesh(2, 2), scfg, n_lanes=4)          # divides: OK
    with pytest.raises(ValueError) as got:
        check_mesh(_StubMesh(*stub), scfg, n_lanes)
    with pytest.raises(ValueError) as want:
        JD.check_mesh(_StubMesh(*stub), scfg, n_lanes)
    assert str(got.value) == str(want.value)


def test_make_mesh_too_few_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh(2, 1)
    with pytest.raises(RuntimeError, match="devices="):
        make_host_mesh(2)


def test_mesh_shapes_and_devices():
    mesh = make_mesh(2, 3, device="cpu")
    assert mesh.axis_names == (CFG_AXIS, SM_AXIS)
    assert mesh.shape == {"cfg": 2, "sm": 3}
    assert mesh.devices.shape == (2, 3)
    assert mesh.describe()["devices"] == ["cpu"] * 6
    assert make_mesh(1, 2, devices=["cpu", "cpu"]).shape == {"cfg": 1,
                                                              "sm": 2}
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        make_mesh(2, 2, devices=["cpu", "cpu"])
    host = make_host_mesh(4, device="cpu")
    assert host.axis_names == ("sm",) and host.shape == {"sm": 4}
    with pytest.raises(ValueError, match="one device type"):
        Mesh(["cpu", "meta"], ("sm",))
    # the mesh's devices win; a device of another type conflicts
    assert mesh_device(mesh, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's devices win"):
        mesh_device(mesh, "cuda")
    assert state_specs(None, CFG_AXIS, telem=True) == {
        "warp": (None, "cfg", "sm"), "sm": (None, "cfg", "sm"),
        "req": (None, "cfg", "sm"), "stats_sm": (None, "cfg", "sm"),
        "mem": (None, "cfg"), "ctrl": (None, "cfg"), "stats": (None, "cfg"),
        "telem": (None, "cfg")}


def test_runplan_mesh_describe_equals_reference():
    got = RunPlan(mesh=make_mesh(2, 2, device="cpu")).describe()
    want = JPLAN.RunPlan(mesh=_StubMesh(2, 2)).describe()
    assert got == want and got["mesh"] == [2, 2]


def test_pair_sweep_and_service_refuse_a_mesh():
    plan = RunPlan(mesh=make_mesh(1, 2, device="cpu"))
    w = resolve_workload("trace:vecadd")
    with pytest.raises(ValueError, match="use grid_sweep for mesh runs"):
        pair_sweep([(w, TINY)], plan=plan, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SimService(base=TINY, plan=plan, device="cpu")


@pytest.fixture
def runs(tmp_path, monkeypatch):
    d = tmp_path / "runs"
    monkeypatch.setattr(T, "runs_dir", lambda: str(d))
    return d


def _manifest(runs):
    [path] = list(runs.glob("*.json"))
    with open(path) as f:
        return json.load(f)


def test_dse_mesh_check(runs, capsys):
    dse.main(["--workload", "nn", "--scale", "0.02", "--n", "4", "--mesh",
              "2", "2", "--check", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "[dse] check OK: all 4 lanes bit-exact vs solo"
    assert out[-3].startswith("[dse] 4 configs × nn: one lockstep run on "
                              "2x2 ('cfg','sm') mesh, wall=")
    man = _manifest(runs)
    assert man["mesh_shape"] == [2, 2]
    assert man["plan"]["mesh"] == [2, 2]


def test_zoo_grid_mesh_check(runs, capsys):
    zoo.main(["--trace", os.path.join(HERE, "data", "traces"), "--grid", "2",
              "2", "--mesh", "2", "2", "--check", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "[zoo] check OK: all 4 lanes bit-exact vs solo runs"
    assert "on 2x2 ('cfg','sm') mesh, wall=" in out[-3]
    man = _manifest(runs)
    assert man["mesh_shape"] == [2, 2]
    assert man["plan"]["mesh"] == [2, 2]
