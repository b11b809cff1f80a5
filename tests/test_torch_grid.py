"""Grid sweeps: every (workload, config) lane of the port's ``grid_sweep``
— padded, ragged and bucketed — equals the JAX package's grid lane, bit
for bit on ``comparable()``, ``total_cycles`` and ``timeouts``; and
``launch/zoo.py --trace tests/data/traces --grid 3 2 --check`` passes on
the CPU (every lane against the port's solo run).

Workloads: two small zoo workloads (one with three kernels, padded with
an empty kernel in the grid) and two traces (two kernels and one)."""
import dataclasses
import json
import os

import pytest
import torch

import repro.core.plan as JPLAN
import repro.core.stats as JS
import repro.core.sweep as JSW
import repro.sim.config as JC
import repro.sim.workloads as JZ
from repro_torch.core import stats as S
from repro_torch.core.plan import RunPlan
from repro_torch.core.sweep import grid_sweep
from repro_torch.launch import zoo
from repro_torch.sim.config import TINY
from repro_torch.sim.workloads import resolve_workload

MAX_CYCLES = 1 << 15
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "determinism_tiny.json")
NAMES = ("zoo:reduction_tree", "zoo:tensor_heavy", "trace:gather_chain",
         "trace:vecadd")
OVERRIDES = [dict(),
             dict(scheduler="lrr", l2_lat=64),
             dict(disp_of_class=(3, 2, 6, 4, 1, 1, 1), icnt_lat=24)]


def scale(name):
    return 0.005 if name.startswith("zoo:") else 1.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_grid():
    return JSW.grid_sweep(
        [JZ.resolve_workload(n, scale(n)) for n in NAMES],
        [dataclasses.replace(JC.TINY, **o) for o in OVERRIDES],
        plan=JPLAN.RunPlan(max_cycles=MAX_CYCLES))


def port_grid(**plan):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return grid_sweep([resolve_workload(n, scale(n)) for n in NAMES],
                          [dataclasses.replace(TINY, **o) for o in OVERRIDES],
                          plan=RunPlan(max_cycles=MAX_CYCLES, **plan),
                          device="cpu")
    finally:
        torch.set_num_threads(n)


PLANS = {"padded": {}, "ragged": dict(layout="ragged"),
         "bucketed": dict(bucket_by="shape", max_buckets=2,
                          layout="ragged")}


@pytest.mark.parametrize("plan", list(PLANS))
def test_grid_lanes_equal_jax_grid(jax_grid, plan):
    grid = port_grid(**PLANS[plan])
    assert grid.names == [n.split("zoo:")[-1] for n in NAMES]
    assert (grid.n_workloads, grid.n_cfgs) == (len(NAMES), len(OVERRIDES))
    for w in range(len(NAMES)):
        for c in range(len(OVERRIDES)):
            got, want = grid.stats[w][c], jax_grid.stats[w][c]
            assert dict(S.comparable(got), timeouts=got["timeouts"]) == \
                dict(JS.comparable(want), timeouts=want["timeouts"]), \
                (NAMES[w], c)
            assert int(grid.lane_state(w, c)["ctrl"]["total_cycles"]) == \
                int(jax_grid.lane_state(w, c)["ctrl"]["total_cycles"])
    # the trace golden sits at its lane
    with open(GOLDEN) as f:
        assert S.comparable(grid.stats[2][0]) == \
            json.load(f)["trace:gather_chain@1.0"]
    if plan == "bucketed":
        assert grid.timings["n_buckets"] == len(grid.buckets) == 2
        assert grid.state is None
        assert sorted(i for idxs, _ in grid.buckets for i in idxs) == \
            list(range(len(NAMES)))
    else:
        assert grid.timings["n_buckets"] == 1
        assert grid.state["ctrl"]["cycle"].shape == (len(NAMES),
                                                     len(OVERRIDES))
    assert grid.timings["n_lanes"] == len(NAMES) * len(OVERRIDES)
    assert grid.timings["compile_s"] is None
    assert [r["workload"] for r in grid.table()][::len(OVERRIDES)] == \
        grid.names


def test_zoo_trace_grid_check(capsys):
    zoo.main(["--trace", os.path.join(HERE, "data", "traces"), "--grid", "3",
              "2", "--check", "--device", "cpu", "--no-manifest"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "[zoo] check OK: all 6 lanes bit-exact vs solo runs"
    table = json.loads("\n".join(out[:-2]))
    assert [r["workload"] for r in table] == [
        "trace:gather_chain", "trace:gather_chain", "trace:mm_tile",
        "trace:mm_tile", "trace:vecadd", "trace:vecadd"]
    assert out[-2].startswith("[zoo] grid 3 workloads × 2 configs = 6 lanes "
                              "(bucket_by=none layout=padded buckets=1) on "
                              "cpu, wall=")


def test_zoo_trace_summary_check(capsys):
    """``--trace`` alone prints the ingest summary per trace, and with
    --check verifies the (traces × 2 configs) grid against solo runs."""
    zoo.main(["--trace", os.path.join(HERE, "data", "traces", "vecadd.trace"),
              "--check", "--layout", "ragged", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [
        "[zoo] ingested trace:vecadd: 1 kernel(s), 4 CTAs, n_instr=[4], "
        "fit_err mean=0.1667 max=0.5 blocks",
        "[zoo] check OK: 1x2 trace grid bit-exact vs solo runs"]


def test_zoo_run_and_list(capsys):
    zoo.main(["--list", "--device", "cpu"])
    listed = capsys.readouterr().out.split()
    assert [n for n in listed if not n.startswith("trace:")] == [
        n for n in JZ.zoo_names() if not n.startswith("trace:")]
    zoo.main(["--run", "trace:vecadd", "--device", "cpu", "--no-manifest"])
    out = capsys.readouterr().out.strip().splitlines()
    printed = json.loads("\n".join(out[:-1]))
    assert printed["cycles"] == 464 and printed["timeouts"] == 0
    assert out[-1].startswith("[zoo] trace:vecadd: 464 GPU cycles, ipc=")
