"""The port's analytic surrogate and search-driven DSE (sim/features.py,
core/analytic.py, core/search.py) against the JAX package.

Mirrors tests/test_search.py's encoding, space, plan-knob, twin-seed,
calibration and rank-correlation tests at its PLAN and nn@0.05 (its two
buffer-donation tests are about JAX buffer donation and have no
counterpart here), and adds:

  · the port's ``search`` equals the JAX package's for the same seed in
    every field but the timings;
  · features, basis, Spearman, fits and predicted costs equal the JAX
    package's;
  · ``calibration_rows_from_manifests`` reads the other package's
    manifests as its own;
  · ``RunPlan(bucket_by='cost', max_buckets=None)`` forms the reference's
    buckets;
  · ``dse --search`` writes a search manifest and passes ``--check``;
  · ``--regen`` writes tests/golden/torch_port_search.json, which the
    smoke's search phase on the card holds its search against.

Regenerate that golden from the JAX package with
    PYTHONPATH=src python tests/test_torch_search.py --regen
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import repro.core.analytic as JA
import repro.core.telemetry as JT
import repro.sim.config as JC
import repro.sim.features as JF
from repro.core.plan import RunPlan as JPlan
from repro.core.search import SearchSpace as JSpace
from repro.core.search import search as jsearch
from repro.workloads import make_workload as jmake_workload
from repro_torch.core import analytic
from repro_torch.core import telemetry as T
from repro_torch.core.plan import RunPlan
from repro_torch.core.search import SearchSpace, search
from repro_torch.core.sweep import stack_dyn, sweep
from repro_torch.launch import dse
from repro_torch.sim import features as F
from repro_torch.sim.config import RTX3080TI, TINY, class_index, static_part
from repro_torch.sim.workloads import resolve_workload
from repro_torch.workloads import make_workload

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_port_search.json")
MAX_CYCLES = 1 << 14
PLAN = RunPlan(max_cycles=MAX_CYCLES, search_rounds=2, search_topk=4)
JPLAN = JPlan(max_cycles=MAX_CYCLES, search_rounds=2, search_topk=4)
TIMING = ("analytic_s", "analytic_cands_per_s", "verify_s",
          "verify_lanes_per_s")
# the card's search (chip_smoke.py phase r) and its golden
GOLDEN_CASE = dict(workload="nn", scale=0.5, base="3080ti", seed=0,
                   rounds=3, topk=8, n_candidates=256,
                   max_cycles=1 << 17)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload():
    return make_workload("nn", scale=0.05)


def strip(rounds) -> list:
    """Round reports without their wall-clock fields."""
    return [{k: v for k, v in r.items() if k not in TIMING} for r in rounds]


def search_record(result) -> dict:
    """Everything of a SearchResult but its timings, as plain JSON: what
    the goldens store and the cross-package checks hold equal."""
    return json.loads(json.dumps({
        "seed": result.seed, "space": [list(result.space.lo),
                                       list(result.space.hi)],
        "features": result.features.tolist(),
        "best": {k: list(v) if isinstance(v, tuple) else v
                 for k, v in result.best.items()},
        "best_cycles": result.best_cycles,
        "theta": result.model.theta.tolist(), "calib": result.model.calib,
        "rounds": strip(result.rounds),
        "verified": [[np.asarray(v).tolist(), int(c)]
                     for v, c, _ in result.verified],
    }))


# ---------------------------------------------------------------------------
# parameter-vector encoding and features
# ---------------------------------------------------------------------------

def test_encode_decode_roundtrip():
    vec = analytic.encode_config(TINY)
    assert vec.shape == (analytic.N_PARAMS,)
    assert np.array_equal(vec, JA.encode_config(JC.TINY))
    flat = analytic.decode(vec)
    assert flat == JA.decode(vec)
    assert np.array_equal(analytic.encode(flat), vec)
    scfg, _ = stack_dyn([(static_part(TINY), flat)], "cpu")
    assert scfg == static_part(TINY)
    assert analytic.PARAM_NAMES == JA.PARAM_NAMES
    assert analytic.BASIS_NAMES == JA.BASIS_NAMES


def test_describe_vec_matches_manifest_lane_format():
    vec = analytic.encode_config(TINY)
    lane = analytic.describe_vec(vec)
    assert lane == JA.describe_vec(vec)
    assert lane["scheduler"] == TINY.scheduler
    assert np.array_equal(analytic.params_from_lane(lane), vec)
    assert lane == {k: v for k, v in dse.describe(TINY).items()}
    assert analytic.params_from_lane({"l1_hit_lat": 1}) is None


@pytest.mark.parametrize("name,scale", [("nn", 0.05), ("zoo:mixed", 0.01),
                                        ("trace:gather_chain", 1.0)])
def test_features_equal_reference(name, scale):
    from repro.sim.workloads import resolve_workload as jresolve
    for cfg, jcfg in ((TINY, JC.TINY), (JC.RTX3080TI, JC.RTX3080TI)):
        feats = F.workload_features(resolve_workload(name, scale), cfg)
        assert feats.shape == (F.N_FEATURES,) and feats.dtype == np.float64
        assert np.isfinite(feats).all() and (feats >= 0).all()
        assert np.array_equal(
            feats, JF.workload_features(jresolve(name, scale), jcfg))
    assert F.FEATURE_NAMES == JF.FEATURE_NAMES


def test_basis_spearman_and_fit_equal_reference():
    rng = np.random.default_rng(5)
    feats = rng.random(F.N_FEATURES) * 100
    space = SearchSpace.from_base(TINY)
    params = space.sample(np.random.Generator(np.random.PCG64(1)), 40)
    assert np.array_equal(analytic.basis_matrix(feats, params),
                          JA.basis_matrix(feats, params))
    a, b = rng.random(30), rng.random(30)
    b[3] = b[4]
    assert analytic.spearman(a, b) == JA.spearman(a, b)
    assert analytic.spearman([1, 1, 1], b[:3]) is None
    rows = [(feats, p, float(c)) for p, c in
            zip(params, rng.integers(1000, 5000, len(params)))]
    got, want = analytic.CostModel.fit(rows), JA.CostModel.fit(rows)
    assert np.array_equal(got.theta, want.theta)
    assert got.calib == want.calib
    assert np.array_equal(got.predict(feats, params),
                          want.predict(feats, params))
    assert analytic.CostModel.fit([]).calib == JA.CostModel.fit([]).calib


def test_predicted_workload_cost_equal_reference():
    from repro.sim.workloads import resolve_workload as jresolve
    for name, scale in (("nn", 0.05), ("trace:vecadd", 1.0)):
        assert analytic.predicted_workload_cost(
            resolve_workload(name, scale), TINY) == \
            JA.predicted_workload_cost(jresolve(name, scale), JC.TINY)


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------

def test_space_bounds_and_sampling():
    space = SearchSpace.from_base(TINY)
    jspace = JSpace.from_base(JC.TINY)
    assert (space.lo, space.hi) == (jspace.lo, jspace.hi)
    lo, hi = np.asarray(space.lo), np.asarray(space.hi)
    assert (lo <= hi).all()
    icnt = analytic.P_SCALARS.index("icnt_lat")
    assert lo[icnt] >= TINY.quantum
    rng = np.random.Generator(np.random.PCG64(3))
    jrng = np.random.Generator(np.random.PCG64(3))
    cands = space.sample(rng, 64)
    assert np.array_equal(cands, jspace.sample(jrng, 64))
    assert ((cands >= lo) & (cands <= hi)).all()
    kids = space.mutate(rng, cands[:4], 32)
    assert np.array_equal(kids, jspace.mutate(jrng, cands[:4], 32))
    assert ((kids >= lo) & (kids <= hi)).all()


def test_space_sample_triples_override_bounds():
    space = SearchSpace.from_base(TINY, spread=3.0,
                                  sample_lat=[("fp32", 2, 9)],
                                  sample_disp=[("sfu", 1, 3)])
    i = analytic.P_LAT + class_index("fp32")
    assert (space.lo[i], space.hi[i]) == (2, 9)
    j = analytic.P_DISP + class_index("sfu")
    assert (space.lo[j], space.hi[j]) == (1, 3)
    jspace = JSpace.from_base(JC.TINY, spread=3.0,
                              sample_lat=[("fp32", 2, 9)],
                              sample_disp=[("sfu", 1, 3)])
    assert (space.lo, space.hi) == (jspace.lo, jspace.hi)


def test_space_validation():
    with pytest.raises(ValueError, match="must have 21 dims"):
        SearchSpace(lo=(0,), hi=(1,))
    good = SearchSpace.from_base(TINY)
    with pytest.raises(ValueError, match="lo=.* > hi="):
        SearchSpace(lo=good.hi, hi=good.lo)


# ---------------------------------------------------------------------------
# RunPlan search knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"search_seed": -1},
    {"search_rounds": 0},
    {"search_topk": 0},
    {"max_buckets": 0},
])
def test_plan_rejects_bad_search_knobs(kw):
    with pytest.raises(ValueError) as got:
        RunPlan(**kw)
    with pytest.raises(ValueError) as want:
        JPlan(**kw)
    assert str(got.value) == str(want.value)


def test_plan_accepts_search_knobs_and_describes_them():
    kw = dict(search_seed=11, search_rounds=5, search_topk=2,
              max_buckets=None)
    d = RunPlan(**kw).describe()
    assert (d["search_seed"], d["search_rounds"], d["search_topk"]) \
        == (11, 5, 2)
    assert d["max_buckets"] is None
    assert d == JPlan(**kw).describe()


# ---------------------------------------------------------------------------
# seeded search: determinism, the reference's result, calibration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twin_results(workload):
    torch.set_num_threads(1)
    space = SearchSpace.from_base(TINY)
    kw = dict(plan=PLAN, base=TINY, n_candidates=48, calibrate_from=None,
              device="cpu")
    return (search(workload, space, seed=7, **kw),
            search(workload, space, seed=7, **kw),
            search(workload, space, seed=8, **kw))


def test_search_same_seed_bit_reproducible(twin_results):
    a, b, _ = twin_results
    assert search_record(a) == search_record(b)


def test_search_different_seed_differs(twin_results):
    a, _, c = twin_results
    assert any(not np.array_equal(va, vc)
               for (va, _, _), (vc, _, _) in zip(a.verified, c.verified))


def test_search_equals_reference(twin_results):
    """The port's search of seed 7 equals the JAX package's in every
    field but the timings: candidates, verified vectors and cycles,
    rank correlations, calibration, θ and the best."""
    a = twin_results[0]
    want = jsearch(jmake_workload("nn", scale=0.05), JSpace.from_base(
        JC.TINY), plan=JPLAN, seed=7, base=JC.TINY, n_candidates=48,
        calibrate_from=None)
    assert search_record(a) == search_record(want)
    assert a.report()["best"] == want.report()["best"]
    assert strip(a.report()["rounds"]) == strip(want.report()["rounds"])
    for (_, _, st), (_, _, jst) in zip(a.verified, want.verified):
        assert {k: v for k, v in st.items() if not k.endswith("_per_sm")} \
            == {k: v for k, v in jst.items() if not k.endswith("_per_sm")}


def test_search_calibration_and_rank_correlation(twin_results):
    a, _, _ = twin_results
    calib = a.model.calib
    assert calib["n_rows"] == len(a.verified) >= PLAN.search_topk
    assert calib["mean_rel_err"] <= 0.25
    assert calib["rank_corr"] is None or calib["rank_corr"] >= 0.5


def test_search_beats_or_matches_every_verified_lane(twin_results, workload):
    a, _, _ = twin_results
    assert a.best_cycles == min(c for _, c, _ in a.verified)
    res = sweep(workload, [(static_part(TINY), a.best)], plan=PLAN,
                device="cpu")
    assert res.cycles[0] == a.best_cycles


def test_analytic_rank_correlation_on_latency_axis(workload):
    scfg = static_part(TINY)
    base = analytic.encode_config(TINY)
    i_l2 = analytic.P_SCALARS.index("l2_lat")
    axis = np.stack([base] * 8)
    axis[:, i_l2] = np.arange(4, 36, 4)
    res = sweep(workload, [(scfg, analytic.decode(v)) for v in axis],
                plan=PLAN, device="cpu")
    feats = F.workload_features(workload, scfg)
    measured = np.asarray(res.cycles, np.float64)
    model = analytic.CostModel.fit(
        [(feats, v, c) for v, c in zip(axis[::2], measured[::2])])
    assert model.calib["mean_rel_err"] <= 0.05
    pred = model.predict(feats, axis[1::2])
    corr = analytic.spearman(pred, measured[1::2])
    assert corr is not None and corr >= 0.5, (corr, model.calib)


# ---------------------------------------------------------------------------
# manifest calibration rows, across the packages
# ---------------------------------------------------------------------------

def test_calibration_rows_roundtrip(tmp_path, workload):
    scfg = static_part(TINY)
    feats = F.workload_features(workload, scfg)
    vec = analytic.encode_config(TINY)
    T.write_manifest("search", scfg=scfg, stats=[{"cycles": 1234}],
                     lanes=[analytic.describe_vec(vec)],
                     extra={"features": feats.tolist()},
                     out_dir=str(tmp_path / "port"), device="cpu")
    JT.write_manifest("search", scfg=JC.static_part(JC.TINY),
                      stats=[{"cycles": 999}],
                      lanes=[JA.describe_vec(vec)],
                      extra={"features": feats.tolist()},
                      out_dir=str(tmp_path / "jax"))
    (tmp_path / "port" / "junk.json").write_text("{not json")
    for d, cycles in (("port", 1234.0), ("jax", 999.0)):
        rows = analytic.calibration_rows_from_manifests(
            scfg, str(tmp_path / d))
        jrows = JA.calibration_rows_from_manifests(
            JC.static_part(JC.TINY), str(tmp_path / d))
        assert len(rows) == len(jrows) == 1
        for (f, v, c), (jf, jv, jc) in zip(rows, jrows):
            assert np.array_equal(f, feats) and np.array_equal(f, jf)
            assert np.array_equal(v, vec) and np.array_equal(v, jv)
            assert c == jc == cycles
    other = dataclasses.replace(scfg, n_sm=scfg.n_sm * 2)
    assert analytic.calibration_rows_from_manifests(
        other, str(tmp_path / "port")) == []


def test_search_warm_starts_from_manifests(tmp_path, workload):
    """calibrate_from=DIR fits the first round's surrogate on the rows a
    previous search wrote there, as the reference does."""
    scfg = static_part(TINY)
    feats = F.workload_features(workload, scfg)
    axis = np.stack([analytic.encode_config(TINY)] * 3)
    axis[:, analytic.P_SCALARS.index("l2_lat")] = (8, 32, 64)
    lanes = [analytic.describe_vec(v) for v in axis]
    stats = [{"cycles": c} for c in (900, 1100, 1500)]
    T.write_manifest("search", scfg=scfg, stats=stats, lanes=lanes,
                     extra={"features": feats.tolist()},
                     out_dir=str(tmp_path), device="cpu")
    plan = RunPlan(max_cycles=MAX_CYCLES, search_rounds=1, search_topk=2)
    got = search(workload, plan=plan, base=TINY, n_candidates=16,
                 calibrate_from=str(tmp_path), device="cpu")
    want = jsearch(jmake_workload("nn", scale=0.05), plan=JPlan(
        max_cycles=MAX_CYCLES, search_rounds=1, search_topk=2),
        base=JC.TINY, n_candidates=16, calibrate_from=str(tmp_path))
    assert search_record(got) == search_record(want)
    assert got.model.calib["n_rows"] == 3 + 2


# ---------------------------------------------------------------------------
# cost buckets with the automatic count
# ---------------------------------------------------------------------------

def test_cost_buckets_auto_count_equal_reference(tmp_path, monkeypatch):
    from repro.core.sweep import bucket_groups as jbucket_groups
    from repro.sim.workloads import resolve_workload as jresolve
    from repro_torch.core.sweep import bucket_groups, grid_sweep
    monkeypatch.chdir(tmp_path)           # no manifest hints from the repo
    names = [("trace:vecadd", 1.0), ("nn", 0.02), ("zoo:mixed", 0.005),
             ("trace:gather_chain", 1.0), ("zoo:reduction_tree", 0.005)]
    plan = RunPlan(bucket_by="cost", max_buckets=None, max_cycles=MAX_CYCLES)
    jplan = JPlan(bucket_by="cost", max_buckets=None, max_cycles=MAX_CYCLES)
    ws = [resolve_workload(n, s) for n, s in names]
    got = bucket_groups(ws, plan, static_part(TINY))
    want = jbucket_groups([jresolve(n, s) for n, s in names], jplan,
                          JC.static_part(JC.TINY))
    assert got == want and len(got) > 1
    from repro_torch.core.stats import comparable
    small = [ws[0], ws[3]]
    grid = grid_sweep(small, [TINY], plan=plan, device="cpu")
    flat = grid_sweep(small, [TINY], plan=RunPlan(max_cycles=MAX_CYCLES),
                      device="cpu")
    assert grid.timings["n_buckets"] == 2
    assert [comparable(r[0]) for r in grid.stats] == \
        [comparable(r[0]) for r in flat.stats]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_dse_search_launcher(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(T, "runs_dir", lambda: str(tmp_path))
    argv = ["--workload", "nn", "--scale", "0.02", "--search",
            "--search-rounds", "2", "--search-topk", "2",
            "--search-cands", "16", "--search-seed", "3", "--check",
            "--max-cycles", str(MAX_CYCLES), "--device", "cpu"]
    dse.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "[dse] check OK: all 4 verified lanes bit-exact vs solo"
    [path] = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    assert out[-2] == f"[dse] manifest: {path}"
    with open(path) as f:
        m = json.load(f)
    assert m["kind"] == "search" and m["workload"] == "nn"
    assert len(m["lanes"]) == len(m["stats"]) == 4
    assert m["search"]["n_verified"] == 4
    assert m["plan"]["search_seed"] == 3
    # the reference's run_search gives search() no base, so --base tiny
    # searches the RTX 3080 Ti's machine shape (ROADMAP.md §3, F6); the
    # port does the same
    rtx = static_part(RTX3080TI)
    assert m["static_config_hash"] == T.static_hash(rtx)
    # the manifest is what the next search warm-starts from
    rows = analytic.calibration_rows_from_manifests(rtx, str(tmp_path))
    assert len(rows) == 4
    assert analytic.calibration_rows_from_manifests(
        static_part(TINY), str(tmp_path)) == []
    with pytest.raises(SystemExit, match="separate modes"):
        dse.main(argv + ["--axis", "l2_lat", "--values", "8"])


def test_lane_config_replays_a_lane():
    vec = analytic.encode_config(dataclasses.replace(TINY, l2_lat=40,
                                                     scheduler="lrr"))
    cfg = dse.lane_config(static_part(TINY), analytic.decode(vec))
    assert cfg == dataclasses.replace(TINY, l2_lat=40, scheduler="lrr")


# ---------------------------------------------------------------------------
# the card's golden
# ---------------------------------------------------------------------------

def test_golden_matches_the_smoke_case():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["case"] == GOLDEN_CASE
    rec = golden["result"]
    assert len(rec["verified"]) == GOLDEN_CASE["rounds"] * GOLDEN_CASE["topk"]
    assert rec["best_cycles"] == min(c for _, c in rec["verified"])


def test_regen_writes_golden(tmp_path, workload):
    """``--regen``'s writer, on a small case: the file holds the port's
    search of the same case."""
    case = dict(workload="nn", scale=0.05, base="tiny", seed=2, rounds=1,
                topk=2, n_candidates=16, max_cycles=MAX_CYCLES)
    path = str(tmp_path / "golden.json")
    _regen(path, case)
    with open(path) as f:
        golden = json.load(f)
    assert golden["case"] == case
    got = search(workload, plan=RunPlan(max_cycles=MAX_CYCLES,
                                        search_rounds=1, search_topk=2),
                 seed=2, base=TINY, n_candidates=16, device="cpu")
    assert search_record(got) == golden["result"]


def _regen(path=GOLDEN, case=None):
    """The JAX package's search of ``case`` (default GOLDEN_CASE)."""
    from repro.launch.dse import BASES
    case = dict(case or GOLDEN_CASE)
    base = BASES[case["base"]]
    result = jsearch(
        jmake_workload(case["workload"], scale=case["scale"]),
        plan=JPlan(max_cycles=case["max_cycles"],
                   search_rounds=case["rounds"], search_topk=case["topk"]),
        seed=case["seed"], base=base, n_candidates=case["n_candidates"],
        calibrate_from=None, log=print)
    with open(path, "w") as f:
        json.dump({"case": case, "result": search_record(result)}, f,
                  sort_keys=True)
    print(f"wrote {path}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
