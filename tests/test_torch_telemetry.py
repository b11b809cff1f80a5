"""Counter timelines and run manifests of the port (core/telemetry.py,
launch/report.py) against the JAX package.

Mirrors tests/test_telemetry.py, its 2-D ('cfg','sm') mesh case on a
mesh that puts the CPU at every position included:

1. off is free: ``telemetry_samples == 0`` leaves the state without a
   ``telem`` part and finalize without telemetry keys;
2. on is invisible to timing: ``comparable()`` equals the telemetry-off
   run and the goldens;
3. the last sample is the final state, in every mode and lane;

and holds the port's timelines, ``lockstep_waste`` and
``telemetry_samples`` equal to the JAX package's, row for row, solo in
seq and vmap, for sweep lanes (a full buffer included) and grid lanes;
every sweep lane equal to its solo run; manifests written by the port
rendered by the port's report as by the reference's; and nn@0.5 at the
RTX 3080 Ti's full width equal to tests/golden/torch_port_telemetry.json.

Regenerate that golden from the JAX package with
    PYTHONPATH=src python tests/test_torch_telemetry.py --regen
"""
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import repro.core.stats as JS
import repro.core.telemetry as JT
import repro.sim.config as JC
from repro.core.engine import simulate as jsimulate
from repro.core.parallel import make_sm_runner as jrunner
from repro.core.sweep import grid_sweep as jgrid_sweep
from repro.core.sweep import sweep as jsweep
from repro.launch import report as jreport
from repro.sim.workloads import resolve_workload as jresolve
from repro_torch.core import stats as S
from repro_torch.core import telemetry as T
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.stats import take_grid_lane, take_lane
from repro_torch.core.sweep import grid_sweep, pair_sweep, sweep
from repro_torch.launch import dse, report, zoo
from repro_torch.sim.config import RTX3080TI, TINY, static_part
from repro_torch.sim.state import init_state
from repro_torch.sim.workloads import resolve_workload

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_port_telemetry.json")
TINY_GOLDEN = os.path.join(HERE, "golden", "determinism_tiny.json")
FULL_GOLDEN = os.path.join(HERE, "golden", "torch_port_rtx3080ti.json")
MAX = 1 << 14
# a full buffer on zoo:mixed@0.005 (7,664 cycles: 239 sampling quanta)
TELEM = dataclasses.replace(TINY, telemetry_samples=32, telemetry_every=2)
JTELEM = dataclasses.replace(JC.TINY, telemetry_samples=32,
                             telemetry_every=2)
MIXED = ("zoo:mixed", 0.005)
# the full-width golden: the smoke's telemetry phase on the card reads it
FULL_SAMPLES, FULL_EVERY, FULL_MAX_CYCLES = 64, 16, 1 << 17
FULL_CASES = (("nn", 0.5), ("syrk", 0.16))


@pytest.fixture(autouse=True)
def _one_thread():
    """The simulator's tensors are tiny; torch's intra-op threads only add
    contention between test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def runs(tmp_path, monkeypatch):
    """The port's manifests go to a temporary runs directory."""
    d = tmp_path / "runs"
    monkeypatch.setattr(T, "runs_dir", lambda: str(d))
    return d


def load(path):
    with open(path) as f:
        return json.load(f)


def port_run(name, scale, cfg, mode="vmap", max_cycles=MAX):
    return simulate(resolve_workload(name, scale), cfg,
                    make_sm_runner(cfg, mode), plan=RunPlan(
                        max_cycles=max_cycles), device="cpu")


def jax_run(name, scale, cfg, mode="vmap", max_cycles=MAX):
    from repro.core.plan import RunPlan as JPlan
    return jsimulate(jresolve(name, scale), cfg, jrunner(cfg, mode),
                     plan=JPlan(max_cycles=max_cycles))


def telemetry_of(timeline, stats) -> dict:
    """What the goldens and the cross-package checks hold equal."""
    return {"timeline": np.asarray(timeline).tolist(),
            "lockstep_waste": stats["lockstep_waste"],
            "telemetry_samples": stats["telemetry_samples"]}


# ---------------------------------------------------------------------------
# 1. off is free
# ---------------------------------------------------------------------------

def test_off_state_unchanged():
    assert not T.enabled(static_part(TINY))
    assert "telem" not in init_state(TINY, "cpu", 3)
    st = port_run("trace:gather_chain", 1.0, TINY)
    assert "telem" not in st
    out = S.finalize(st)
    assert "lockstep_waste" not in out and "telemetry_samples" not in out
    assert S.comparable(out) == load(TINY_GOLDEN)["trace:gather_chain@1.0"]


def test_on_state_has_telem_part():
    st = init_state(TELEM, "cpu", 3)
    assert tuple(st["telem"]["buf"].shape) == (3, 32, T.N_COUNTERS)
    assert st["telem"]["buf"].dtype == torch.int32
    for k in ("idx", "waste"):
        assert tuple(st["telem"][k].shape) == (3,)
        assert st["telem"][k].dtype == torch.int32
    assert T.COUNTERS == JT.COUNTERS and T.FINAL_MATCH == JT.FINAL_MATCH


# ---------------------------------------------------------------------------
# 2. on is invisible to timing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_on_matches_golden(mode):
    cfg = dataclasses.replace(TINY, telemetry_samples=8, telemetry_every=3)
    out = S.finalize(port_run("trace:gather_chain", 1.0, cfg, mode,
                              1 << 15))
    assert S.comparable(out) == load(TINY_GOLDEN)["trace:gather_chain@1.0"]
    assert out["telemetry_samples"] == 8


# ---------------------------------------------------------------------------
# 3. timelines equal the JAX package's; last sample == finalize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,scale,mode,samples,every", [
    ("zoo:mixed", 0.005, "vmap", 32, 2),          # a full buffer
    ("trace:gather_chain", 1.0, "seq", 64, 1)])   # two kernels, room
def test_timelines_equal_jax(name, scale, mode, samples, every):
    kw = dict(telemetry_samples=samples, telemetry_every=every)
    st = port_run(name, scale, dataclasses.replace(TINY, **kw), mode)
    jst = jax_run(name, scale, dataclasses.replace(JC.TINY, **kw), mode)
    out, jout = S.finalize(st), JS.finalize(jst)
    assert telemetry_of(T.timeline(st), out) == \
        telemetry_of(JT.timeline(jst), jout)
    assert T.timeline(st).dtype == np.int32
    assert T.check_final_sample(st, out) == []
    cyc = T.timeline(st)[:, T.COUNTERS.index("cycle")]
    assert (np.diff(cyc) >= 0).all()
    assert S.comparable(out) == JS.comparable(jout)


@pytest.fixture(scope="module")
def lane_sweeps():
    """One port sweep and one JAX sweep of three configs over
    zoo:mixed@0.005 with a full 32-row buffer every 2 quanta."""
    torch.set_num_threads(1)
    over = [{}, dict(scheduler="lrr"), dict(l2_lat=64)]
    cfgs = [dataclasses.replace(TELEM, **o) for o in over]
    jcfgs = [dataclasses.replace(JTELEM, **o) for o in over]
    got = sweep(resolve_workload(*MIXED), cfgs, plan=RunPlan(max_cycles=MAX),
                device="cpu")
    from repro.core.plan import RunPlan as JPlan
    want = jsweep(jresolve(*MIXED), jcfgs, plan=JPlan(max_cycles=MAX))
    return cfgs, got, want


def test_sweep_lanes_equal_jax(lane_sweeps):
    cfgs, got, want = lane_sweeps
    tls, jtls = got.timelines(), want.timelines()
    assert set(tls) == set(jtls) == {"0", "1", "2"}
    for i in range(len(cfgs)):
        assert telemetry_of(tls[str(i)], got.stats[i]) == \
            telemetry_of(jtls[str(i)], want.stats[i]), i
        assert got.stats[i]["telemetry_samples"] == 32      # full buffer
        assert T.check_final_sample(take_lane(got.state, i),
                                    got.stats[i]) == []
    assert not np.array_equal(tls["0"], tls["2"])


def test_sweep_lanes_equal_solo_runs(lane_sweeps):
    cfgs, got, _ = lane_sweeps
    tls = got.timelines()
    for i, cfg in enumerate(cfgs):
        st = port_run(*MIXED, cfg)
        out = S.finalize(st)
        assert telemetry_of(T.timeline(st), out) == \
            telemetry_of(tls[str(i)], got.stats[i]), i
        assert S.comparable(out) == S.comparable(got.stats[i])


GRID_NAMES = ("trace:gather_chain", "trace:vecadd", "trace:mm_tile")
GRID_OVER = [{}, dict(scheduler="lrr")]
GRID_PLAN = dict(max_cycles=MAX, bucket_by="shape", max_buckets=2,
                 telemetry_samples=16, telemetry_every=2)


def trace_grid(**kw):
    """The port's grid of three traces x two configs, ``GRID_PLAN`` with
    ``kw`` over it."""
    return grid_sweep([resolve_workload(n) for n in GRID_NAMES],
                      [dataclasses.replace(TINY, **o) for o in GRID_OVER],
                      plan=RunPlan(**dict(GRID_PLAN, **kw)), device="cpu")


@pytest.fixture(scope="module")
def one_bucket_grid():
    """The trace grid in one bucket, made on first use."""
    return trace_grid(bucket_by="none")


def test_grid_lanes_equal_jax(one_bucket_grid):
    """A grid of three traces x two configs in two shape buckets: every
    lane's timeline equals the JAX package's and the port's one-bucket
    grid's (a lane equals its solo run however it is bucketed)."""
    from repro.core.plan import RunPlan as JPlan
    names = GRID_NAMES
    got = trace_grid()
    assert got.timings["n_buckets"] == 2
    want = jgrid_sweep([jresolve(n) for n in names],
                       [dataclasses.replace(JC.TINY, **o) for o in GRID_OVER],
                       plan=JPlan(**dict(GRID_PLAN, bucket_by="none")))
    one = one_bucket_grid
    tls, jtls, one_tls = got.timelines(), want.timelines(), one.timelines()
    assert list(tls) == list(jtls) == list(one_tls) == \
        [f"{n}/{c}" for n in names for c in range(2)]
    for w in range(len(names)):
        for c in range(2):
            key = f"{names[w]}/{c}"
            assert telemetry_of(tls[key], got.stats[w][c]) == \
                telemetry_of(jtls[key], want.stats[w][c]) == \
                telemetry_of(one_tls[key], one.stats[w][c]), key
            assert T.check_final_sample(got.lane_state(w, c),
                                        got.stats[w][c]) == [], key
            assert np.array_equal(
                T.timeline(take_grid_lane(one.state, w, c)), tls[key])


def test_mesh_final_samples_and_timelines_match_single_device(
        one_bucket_grid):
    """2-D ('cfg','sm') mesh: per-lane final samples still equal finalize
    totals (the counter sums add over each group's SM blocks, the
    reference's psum over 'sm'), and the sampled timelines equal the
    single-device run's row for row (tests/test_telemetry.py's mesh case,
    on the trace grid above instead of two zoo workloads at 0.02, to stay
    cheap here)."""
    from repro_torch.core.distribute import make_mesh
    out = {}
    for label, g in (("nomesh", one_bucket_grid),
                     ("2x2", trace_grid(bucket_by="none",
                                        mesh=make_mesh(2, 2,
                                                       device="cpu")))):
        lanes = [(w, c) for w in range(len(GRID_NAMES))
                 for c in range(len(GRID_OVER))]
        out[label] = {
            "bad": [f"{w}/{c}:{n}" for w, c in lanes
                    for n in T.check_final_sample(
                        take_grid_lane(g.state, w, c), g.stats[w][c])],
            "comparable": [S.comparable(g.stats[w][c]) for w, c in lanes],
            "waste": [g.stats[w][c]["lockstep_waste"] for w, c in lanes],
            "timelines": {k: v.tolist() for k, v in g.timelines().items()},
        }
    assert out["nomesh"]["bad"] == []
    assert out["2x2"]["bad"] == []
    assert out["2x2"]["comparable"] == out["nomesh"]["comparable"]
    assert out["2x2"]["waste"] == out["nomesh"]["waste"]
    assert out["2x2"]["timelines"] == out["nomesh"]["timelines"]
    assert all(len(t) > 2 for t in out["nomesh"]["timelines"].values())
    assert any(w > 0 for w in out["nomesh"]["waste"])


def test_pair_sweep_lanes_carry_timelines():
    w = resolve_workload("trace:vecadd")
    cfgs = [TELEM, dataclasses.replace(TELEM, l2_lat=64)]
    res = pair_sweep([(w, c) for c in cfgs], device="cpu")
    for i, cfg in enumerate(cfgs):
        st = port_run("trace:vecadd", 1.0, cfg)
        assert np.array_equal(T.timeline(res.lane_state(i)), T.timeline(st))
        assert res.stats[i]["lockstep_waste"] == \
            S.finalize(st)["lockstep_waste"]


def test_sweep_comparable_off_vs_on():
    cfgs_off = [TINY, dataclasses.replace(TINY, scheduler="lrr")]
    w = resolve_workload("trace:gather_chain")
    off = sweep(w, cfgs_off, plan=RunPlan(max_cycles=MAX), device="cpu")
    on = sweep(w, cfgs_off, plan=RunPlan(max_cycles=MAX,
                                         telemetry_samples=16),
               device="cpu")
    for i in range(2):
        assert S.comparable(off.stats[i]) == S.comparable(on.stats[i])
    assert off.timelines() == {}
    assert set(on.timelines()) == {"0", "1"}
    assert on.scfg.telemetry_samples == 16


def test_apply_telemetry_equal():
    from repro.core.plan import RunPlan as JPlan
    kw = dict(telemetry_samples=8, telemetry_every=4)
    got = RunPlan(**kw).apply_telemetry(
        [TINY, (static_part(TINY), {"l2_lat": 1})])
    want = JPlan(**kw).apply_telemetry(
        [JC.TINY, (JC.static_part(JC.TINY), {"l2_lat": 1})])
    assert [dataclasses.asdict(c) for c in (got[0], got[1][0])] == \
        [dataclasses.asdict(c) for c in (want[0], want[1][0])]
    assert RunPlan().apply_telemetry([TINY]) == [TINY]


# ---------------------------------------------------------------------------
# serialization, manifests and the report CLI
# ---------------------------------------------------------------------------

def test_to_jsonable_roundtrip():
    payload = {
        "a": np.int64(3), "b": np.arange(3), "c": (1, np.float32(2.5)),
        "d": {"nested": torch.zeros((), dtype=torch.int32)},
        "e": True, "f": np.bool_(False), "g": None, "h": "s",
        "i": torch.arange(2, dtype=torch.int32),
    }
    out = json.loads(json.dumps(S.to_jsonable(payload)))
    assert out == {"a": 3, "b": [0, 1, 2], "c": [1, 2.5],
                   "d": {"nested": 0}, "e": True, "f": False,
                   "g": None, "h": "s", "i": [0, 1]}
    assert out["e"] is True and out["f"] is False
    st = port_run("trace:vecadd", 1.0, TELEM)
    json.dumps(S.to_jsonable(S.finalize(st)))


def _printed(capsys, monkeypatch, mod, argv):
    """(exit code, standard output) of ``mod``'s report CLI.  Its timeline
    writer binds ``sys.stdout`` when the module is imported; here it
    writes to the ``sys.stdout`` of the call, which capsys reads."""
    render = mod.render_timeline
    with monkeypatch.context() as mp:
        mp.setattr(mod, "render_timeline",
                   lambda *a, **kw: render(*a, out=sys.stdout, **kw))
        capsys.readouterr()
        rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_manifest_renders_as_reference(tmp_path, lane_sweeps, capsys,
                                       monkeypatch):
    cfgs, got, want = lane_sweeps
    lanes = [{"scheduler": c.scheduler, "l2_lat": c.l2_lat} for c in cfgs]
    path = T.write_manifest(
        "testrun", scfg=got.scfg, timings=got.timings, stats=got.stats,
        timelines={k: v.tolist() for k, v in got.timelines().items()},
        lanes=lanes, out_dir=str(tmp_path), device="cpu")
    m = load(path)
    assert m["schema"] == T.MANIFEST_SCHEMA == JT.MANIFEST_SCHEMA
    assert m["kind"] == "testrun"
    assert m["static_config_hash"] == T.static_hash(got.scfg) == \
        JT.static_hash(want.scfg)
    assert m["telemetry"] == {"samples": 32, "every": 2,
                              "counters": list(T.COUNTERS)}
    assert m["host"]["device_platform"] == "cpu"
    assert {"hostname", "torch_version", "device_kind",
            "device_count"} <= set(m["host"])
    assert report.render_timeline(m, out=io.StringIO()) == 0
    for argv in (["summarize", path], ["timeline", path],
                 ["timeline", path, "--csv", "--lane", "1"],
                 ["timeline", path, "--cumulative", "--counters",
                  "issued,lockstep_waste", "--width", "16"],
                 ["list", str(tmp_path)], ["diff", path, path]):
        got = _printed(capsys, monkeypatch, report, argv)
        assert got == _printed(capsys, monkeypatch, jreport, argv), argv
        assert got[0] == 0 and got[1], argv
    # a JAX manifest of the same run against the port's: no difference
    jpath = JT.write_manifest(
        "testrun", scfg=want.scfg, timings=want.timings, stats=want.stats,
        timelines={k: v.tolist() for k, v in want.timelines().items()},
        lanes=lanes, out_dir=str(tmp_path / "jax"))
    assert report.diff_stats(load(jpath), m) == []
    rc, text = _printed(capsys, monkeypatch, report,
                        ["diff", jpath, path, "--strict"])
    assert rc == 0 and "IDENTICAL" in text
    assert _printed(capsys, monkeypatch, jreport, ["summarize", jpath]) == \
        _printed(capsys, monkeypatch, report, ["summarize", jpath])


def test_report_flags_a_bad_final_sample(tmp_path, capsys, monkeypatch):
    st = port_run("trace:vecadd", 1.0, TELEM)
    out = S.finalize(st)
    tl = T.timeline(st).tolist()
    tl[-1][T.COUNTERS.index("issued")] += 1
    path = T.write_manifest("bad", scfg=static_part(TELEM),
                            stats=[out], timelines={"0": tl},
                            out_dir=str(tmp_path), device="cpu")
    rc, text = _printed(capsys, monkeypatch, report, ["timeline", path])
    assert rc == 1 and "MISMATCH vs finalize(): ['issued']" in text
    assert (rc, text) == _printed(capsys, monkeypatch, jreport,
                                  ["timeline", path])


def test_manifest_no_same_second_overwrite(tmp_path):
    a = T.write_manifest("x", out_dir=str(tmp_path))
    b = T.write_manifest("x", out_dir=str(tmp_path))
    assert a != b and os.path.exists(a) and os.path.exists(b)


@pytest.mark.parametrize("cfg,jcfg", [(TINY, JC.TINY),
                                      (RTX3080TI, JC.RTX3080TI),
                                      (TELEM, JTELEM)])
def test_static_hash_equal_across_packages(cfg, jcfg):
    assert T.static_hash(static_part(cfg)) == \
        JT.static_hash(JC.static_part(jcfg))
    assert T.static_hash(static_part(cfg)) != \
        T.static_hash(static_part(dataclasses.replace(cfg, n_sm=2)))


def _manifests(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d)) \
        if os.path.isdir(d) else []


def test_launcher_flags(runs, tmp_path, capsys):
    """dse and zoo write manifests whose timelines verify; --profile
    writes a trace; --no-manifest writes none."""
    dse.main(["--workload", "nn", "--scale", "0.02", "--n", "2",
              "--telemetry", "8", "--telemetry-every", "4", "--check",
              "--max-cycles", str(MAX), "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "[dse] check OK: all 2 lanes bit-exact vs solo"
    [path] = _manifests(runs)
    assert out[-2] == f"[dse] manifest: {path}"
    m = load(path)
    assert m["kind"] == "dse" and m["workload"] == "nn"
    assert set(m["timelines"]) == {"0", "1"}
    assert m["plan"]["telemetry_samples"] == 8
    assert report.render_timeline(m, out=io.StringIO()) == 0

    traces = os.path.join(HERE, "data", "traces")
    zoo.main(["--trace", traces, "--grid", "3", "2", "--telemetry", "4",
              "--max-cycles", str(MAX), "--device", "cpu"])
    m = load(_manifests(runs)[-1])
    assert m["kind"] == "zoo_grid" and m["profile_dir"] is None
    assert len(m["stats"]) == 6 and len(m["timelines"]) == 6
    assert [s["workload"] for s in m["stats"]][::2] == m["workloads"]
    assert report.render_timeline(m, out=io.StringIO()) == 0

    prof = tmp_path / "prof"
    zoo.main(["--run", "trace:vecadd", "--telemetry", "16", "--profile",
              str(prof), "--device", "cpu"])
    m = load(_manifests(runs)[-1])
    assert m["kind"] == "zoo_run" and m["profile_dir"] == str(prof)
    assert list(m["timelines"]) == ["trace:vecadd"]
    assert report.render_timeline(m, out=io.StringIO()) == 0
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]

    n = len(_manifests(runs))
    dse.main(["--workload", "nn", "--scale", "0.02", "--n", "1",
              "--no-manifest", "--device", "cpu"])
    zoo.main(["--run", "trace:vecadd", "--no-manifest", "--device", "cpu"])
    assert len(_manifests(runs)) == n
    capsys.readouterr()


# ---------------------------------------------------------------------------
# full width, against the JAX package's golden
# ---------------------------------------------------------------------------

def full_cfg(base=RTX3080TI):
    return dataclasses.replace(base, telemetry_samples=FULL_SAMPLES,
                               telemetry_every=FULL_EVERY)


def test_full_width_nn_matches_golden():
    golden = load(GOLDEN)
    assert (golden["samples"], golden["every"], golden["max_cycles"]) == \
        (FULL_SAMPLES, FULL_EVERY, FULL_MAX_CYCLES)
    st = port_run("nn", 0.5, full_cfg(), "vmap", FULL_MAX_CYCLES)
    out = S.finalize(st)
    assert out["timeouts"] == 0
    assert telemetry_of(T.timeline(st), out) == golden["cases"]["nn@0.5"]
    assert S.comparable(out) == load(FULL_GOLDEN)["nn@0.5"]
    assert T.check_final_sample(st, out) == []


def test_regen_writes_golden(tmp_path):
    """``--regen``'s writer, on a TINY case: the file it writes is what
    the port computes."""
    path = str(tmp_path / "golden.json")
    _regen(path, JC.TINY, (("trace:vecadd", 1.0),))
    golden = load(path)
    st = port_run("trace:vecadd", 1.0, full_cfg(TINY), "vmap",
                  FULL_MAX_CYCLES)
    assert telemetry_of(T.timeline(st), S.finalize(st)) == \
        golden["cases"]["trace:vecadd@1.0"]


def _regen(path=GOLDEN, base=None, cases=FULL_CASES):
    """The JAX package's timelines of ``cases`` on ``base`` (default: the
    RTX 3080 Ti) with FULL_SAMPLES rows every FULL_EVERY quanta."""
    cfg = dataclasses.replace(base or JC.RTX3080TI,
                              telemetry_samples=FULL_SAMPLES,
                              telemetry_every=FULL_EVERY)
    golden = {"samples": FULL_SAMPLES, "every": FULL_EVERY,
              "max_cycles": FULL_MAX_CYCLES, "cases": {}}
    for name, scale in cases:
        st = jax_run(name, scale, cfg, "vmap", FULL_MAX_CYCLES)
        out = JS.finalize(st)
        assert out["timeouts"] == 0, (name, out["timeouts"])
        golden["cases"][f"{name}@{scale}"] = telemetry_of(JT.timeline(st),
                                                          out)
    with open(path, "w") as f:
        json.dump(golden, f, sort_keys=True)
    print(f"wrote {path}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
