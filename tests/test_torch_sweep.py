"""Lane-batched sweeps: every lane of the port's ``sweep`` and
``pair_sweep`` equals the JAX package's lane and the port's solo run of
its (workload, config) pair, bit for bit on ``comparable()``,
``total_cycles`` and ``timeouts``; and ``launch/dse.py --check`` passes
on the CPU.

The configs are tests/test_dse_sweep.py's six: lanes 0/1 differ only in
the scheduler, lanes 2/3 in scalar latencies, lanes 4/5 in the per-class
tables.  The workload is TINY ``myocyte@1.0`` (hotspot costs ~28 s per
solo run here)."""
import dataclasses
import json
import os

import pytest
import torch

import repro.core.plan as JPLAN
import repro.core.stats as JS
import repro.core.sweep as JSW
import repro.sim.config as JC
import repro.workloads as JW
from repro_torch.core import stats as S
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.sweep import pair_sweep, stack_dyn, sweep
from repro_torch.launch import dse
from repro_torch.sim.config import TINY, split_config
from repro_torch.sim.workloads import resolve_workload

MAX_CYCLES = 1 << 15
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "determinism_tiny.json")
# tests/test_dse_sweep.py's lanes, as field overrides of TINY
OVERRIDES = [
    dict(scheduler="gto"),
    dict(scheduler="lrr"),
    dict(l2_lat=64, dram_row_penalty=48),
    dict(l1_hit_lat=16, icnt_lat=24, scheduler="lrr"),
    dict(lat_of_class=(24, 12, 48, 32, 0, 0, 1)),
    dict(disp_of_class=(3, 2, 6, 4, 1, 1, 1), scheduler="lrr"),
]
CFGS = [dataclasses.replace(TINY, **o) for o in OVERRIDES]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def signature(stats):
    return dict(S.comparable(stats), timeouts=stats["timeouts"])


def solo(workload, cfg, layout="padded"):
    return S.finalize(simulate(
        workload, cfg, make_sm_runner(cfg, "vmap"),
        plan=RunPlan(max_cycles=MAX_CYCLES, layout=layout), device="cpu"))


@pytest.fixture(scope="module")
def port_sweep():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    result = sweep(resolve_workload("myocyte", 1.0), CFGS,
                   plan=RunPlan(max_cycles=MAX_CYCLES, layout="ragged"),
                   device="cpu")
    torch.set_num_threads(n)
    return result


@pytest.fixture(scope="module")
def jax_sweep():
    cfgs = [dataclasses.replace(JC.TINY, **o) for o in OVERRIDES]
    return JSW.sweep(JW.make_workload("myocyte", scale=1.0), cfgs,
                     plan=JPLAN.RunPlan(max_cycles=MAX_CYCLES))


@pytest.mark.parametrize("i", range(len(CFGS)))
def test_lane_equals_jax_lane(port_sweep, jax_sweep, i):
    got, want = port_sweep.stats[i], jax_sweep.stats[i]
    assert signature(got) == dict(JS.comparable(want),
                                  timeouts=want["timeouts"])
    assert int(port_sweep.state["ctrl"]["total_cycles"][i]) == \
        int(jax_sweep.state["ctrl"]["total_cycles"][i])


@pytest.mark.parametrize("i", [0, 1])
def test_lane_equals_solo(port_sweep, i):
    assert signature(port_sweep.stats[i]) == \
        signature(solo(resolve_workload("myocyte", 1.0), CFGS[i]))


def test_sweep_result_shape(port_sweep):
    """Lane 0 is the golden config; the lanes differ; the timings keys
    are the reference's, with nothing compiled."""
    with open(GOLDEN) as f:
        assert S.comparable(port_sweep.stats[0]) == \
            json.load(f)["myocyte@1.0"]
    cycles = port_sweep.cycles
    assert len(set(cycles)) == len(cycles)
    assert S.comparable(port_sweep.stats[5]) != \
        S.comparable(port_sweep.stats[1])
    assert set(port_sweep.timings) == {"n_lanes", "compile_s", "execute_s",
                                       "lanes_per_s"}
    assert port_sweep.timings["compile_s"] is None
    assert port_sweep.timings["n_lanes"] == port_sweep.n == len(CFGS)
    assert port_sweep.table()[0]["cycles"] == cycles[0]
    assert port_sweep.state["ctrl"]["cycle"].shape == (len(CFGS),)


def test_stack_dyn_names_the_lane():
    with pytest.raises(ValueError, match="static shape"):
        stack_dyn([TINY, dataclasses.replace(TINY, n_sm=4)], "cpu")
    with pytest.raises(ValueError, match="empty config list"):
        stack_dyn([], "cpu")
    scfg, dyn = split_config(TINY, device="cpu")
    full = {k: v.tolist() for k, v in dyn.flat().items()}
    with pytest.raises(ValueError, match="config lane 1: unknown dynamic"):
        stack_dyn([TINY, (scfg, {"bogus": 1})], "cpu")
    with pytest.raises(ValueError, match="config lane 1: missing dynamic"):
        stack_dyn([TINY, (scfg, {"l2_lat": 4})], "cpu")
    with pytest.raises(ValueError, match="config lane 0: quantum .*icnt_lat"):
        stack_dyn([(scfg, dict(full, icnt_lat=4))], "cpu")
    _, dyn = stack_dyn(CFGS, "cpu")
    assert dyn.core.lat.shape == (len(CFGS), 7)
    assert dyn.core.sched.tolist() == [0, 1, 0, 1, 0, 1]


def test_sweep_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep(resolve_workload("myocyte", 1.0), CFGS[:1])


# ---------------------------------------------------------------------------
# pair sweep: the three cheap goldens as lanes, in two orders at once
# ---------------------------------------------------------------------------

GOLDEN_CASES = ("myocyte@1.0", "zoo:mixed@0.03", "trace:gather_chain@1.0")


def test_pair_sweep_lanes_equal_goldens():
    """Six lanes — the three goldens, then the same in another order —
    padded to eight by ``lane_quantum=4`` (live duplicates): every lane
    equals its golden and times out nowhere, wherever it sits."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    order = [0, 1, 2, 2, 0, 1]
    pairs = []
    for i in order:
        bench, scale = GOLDEN_CASES[i].rsplit("@", 1)
        pairs.append((resolve_workload(bench, float(scale)), TINY))
    result = pair_sweep(pairs, plan=RunPlan(max_cycles=MAX_CYCLES),
                        lane_quantum=4, device="cpu")
    assert result.n == 6 and len(result.buckets) == 1
    idxs, state = result.buckets[0]
    assert idxs == list(range(6))
    assert state["ctrl"]["cycle"].shape == (8,)       # padded to 8 lanes
    for lane, i in enumerate(order):
        assert S.comparable(result.stats[lane]) == golden[GOLDEN_CASES[i]]
        assert result.stats[lane]["timeouts"] == 0
        assert int(result.lane_state(lane)["ctrl"]["total_cycles"]) == \
            golden[GOLDEN_CASES[i]]["cycles"]
    assert set(result.timings) == {"n_lanes", "n_buckets", "compile_s",
                                   "execute_s", "lanes_per_s"}


def test_pair_sweep_errors():
    with pytest.raises(ValueError, match="empty pair list"):
        pair_sweep([], device="cpu")
    w = resolve_workload("trace:vecadd")
    with pytest.raises(ValueError, match="static shape"):
        pair_sweep([(w, TINY), (w, dataclasses.replace(TINY, n_sm=4))],
                   device="cpu")


# ---------------------------------------------------------------------------
# launch/dse.py
# ---------------------------------------------------------------------------

def test_dse_check_passes(capsys):
    dse.main(["--workload", "nn", "--scale", "0.02", "--n", "4", "--check",
              "--device", "cpu", "--no-manifest"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "[dse] check OK: all 4 lanes bit-exact vs solo"
    rows = json.loads("\n".join(out[:-2]))
    assert [r["scheduler"] for r in rows] == ["gto", "lrr", "gto", "lrr"]
    assert [r["l2_lat"] for r in rows] == [16, 16, 32, 32]
    assert out[-2].startswith("[dse] 4 configs × nn: one lockstep run on "
                              "cpu, wall=")


def test_dse_grids_equal_reference():
    from repro.launch import dse as jdse
    for base in ("tiny", "3080ti"):
        for n in (1, 4, 5):
            got = [dse.describe(c) for c in dse.default_grid(
                dse.BASES[base], n)]
            want = [jdse.describe(c) for c in jdse.default_grid(
                jdse.BASES[base], n)]
            assert got == want
    got = dse.sample_table_grid(TINY, 4, [("fp32", 2, 8)], [("sfu", 1, 9)])
    want = jdse.sample_table_grid(JC.TINY, 4, [("fp32", 2, 8)],
                                  [("sfu", 1, 9)])
    assert [dse.describe(c) for c in got] == [jdse.describe(c) for c in want]
    got = dse.sample_table_grid(TINY, 3, [("tensor", 2, 40)], seed=7)
    want = jdse.sample_table_grid(JC.TINY, 3, [("tensor", 2, 40)], seed=7)
    assert [dse.describe(c) for c in got] == [jdse.describe(c) for c in want]
    assert [dse.describe(c) for c in dse.axis_grid(TINY, "l2_lat",
                                                   ["8", "64"])] == \
        [jdse.describe(c) for c in jdse.axis_grid(JC.TINY, "l2_lat",
                                                  ["8", "64"])]
