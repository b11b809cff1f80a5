"""Batching, plans and lanes: the port's ``core/batch.py`` layouts and
bucketing, ``core/plan.py`` and the lane axis of the quantum step's three
stages, against the JAX package and against one-lane calls.

  · padded and ragged layouts equal the reference's, array for array;
  · bucketing, cost keys and manifest hints equal the reference's;
  · ``RunPlan`` raises the reference's errors, takes a ('cfg','sm') mesh,
    and ``cache_dir`` raises ``NotImplementedError``;
  · padding is inert, and an entry-converged padding kernel runs zero
    quanta;
  · ``mem_phase``, ``cta_issue`` and the eager SM phase over L lanes (each
    lane its own state, trace, dynamic config and clock) equal L one-lane
    calls, and each lane equals the reference's call.
"""
import json
import os
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batch as JB
import repro.core.parallel as JP
import repro.core.plan as JPLAN
import repro.sim.config as JC
import repro.sim.cta as JCTA
import repro.sim.workloads as JZ
import repro_torch.core.batch as PB
import repro_torch.core.plan as PPLAN
import repro_torch.sim.config as PC
import repro_torch.sim.cta as PCTA
import repro_torch.sim.memsys as PM
import repro_torch.sim.workloads as PZ
from repro.core.telemetry import COUNTERS
from repro_torch.convert import (random_lane_inputs, stack_lanes, to_numpy,
                                 to_torch)
from repro_torch.core import stats as S
from repro_torch.core import telemetry as PT
from repro_torch.core.engine import (mark_entry_converged, run_kernel,
                                     run_workload_stacked, simulate)
from repro_torch.core.parallel import make_sm_runner
from repro_torch.launch import dse, zoo
from repro_torch.sim import smcore
from repro_torch.sim.state import init_state
from test_torch_cta import random_inputs as random_cta_inputs
from test_torch_memsys import J_MEM_PHASE, random_mem_inputs

SCALE = 0.005
MAX_CYCLES = 1 << 15
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "determinism_tiny.json")
TRACES = os.path.join(HERE, "data", "traces")
ZOO_MIX = ("gemm_tiled", "mixed", "reduction_tree", "streaming_copy",
           "stencil")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(want, got):
    """A reference tree (jax or numpy leaves) and a port tree of tensors
    hold the same keys, dtypes and values."""
    want = jax.tree_util.tree_map(np.asarray, want)
    got = to_numpy(got) if isinstance(got, dict) else got
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].shape == got[k].shape, k
        assert np.array_equal(want[k], got[k]), k


def workloads(names, scale=SCALE):
    return ([JZ.resolve_workload(n, scale) for n in names],
            [PZ.resolve_workload(n, scale) for n in names])


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

GRID_MIX = ("zoo:mixed", "zoo:reduction_tree", "trace:gather_chain",
            "trace:vecadd")


def test_stack_workloads_equal():
    jw, pw = workloads(GRID_MIX)
    got = PB.stack_workloads(pw, "cpu")
    assert_same(JB.stack_workloads(jw), got)
    # pad kernels are flagged empty, real kernels keep their CTA counts
    assert tuple(got["ops"].shape[:2]) == (4, 4)
    assert (got["n_ctas"][2, 2:] == 0).all()


def test_concat_workloads_equal():
    jw, pw = workloads(GRID_MIX)
    got = PB.concat_workloads(pw, "cpu")
    assert_same(JB.concat_workloads(jw), got)
    # the instr_base offset table: each workload's kernels end to end
    for i, w in enumerate(pw):
        lens = [k.n_instr for k in w.kernels]
        assert got["instr_base"][i, :len(lens)].tolist() == \
            [sum(lens[:j]) for j in range(len(lens))]


@pytest.mark.parametrize("extra", [(0, 0), (3, 2)])
def test_concat_kernels_equal(extra):
    """With and without padding slots (inert zeros past every kernel,
    warps_per_cta padded with 1, never a 0 divisor)."""
    jw, pw = workloads(["zoo:mixed"])
    jp = [k.pack() for k in jw[0].kernels]
    pp = [k.pack("cpu") for k in pw[0].kernels]
    total = sum(k.n_instr for k in pw[0].kernels) + extra[0]
    n_k = len(pp) + extra[1]
    got = PB.concat_kernels(pp, n_instr_total=total, n_kernels=n_k)
    assert_same(JB.concat_kernels(jp, n_instr_total=total, n_kernels=n_k),
                got)
    scan, flat = PB.split_ragged(got)
    jscan, jflat = JB.split_ragged(JB.concat_kernels(jp))
    assert set(scan) == set(jscan) and set(flat) == set(jflat)


def test_layout_errors():
    _, pw = workloads(["zoo:mixed"])
    pp = [k.pack("cpu") for k in pw[0].kernels]
    with pytest.raises(ValueError, match="empty kernel list"):
        PB.concat_kernels([])
    with pytest.raises(ValueError, match="n_instr_total=3"):
        PB.concat_kernels(pp, n_instr_total=3)
    with pytest.raises(ValueError, match="n_kernels=1"):
        PB.concat_kernels(pp, n_kernels=1)
    with pytest.raises(ValueError, match="empty workload list"):
        PB.stack_workloads([], "cpu")
    with pytest.raises(ValueError, match="workload with no kernels"):
        PB.concat_workloads([PZ.Workload("none")], "cpu")


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("by", ["none", "shape", "cost"])
@pytest.mark.parametrize("cap", [1, 2, 3, 8, None])
def test_bucket_workloads_equal(by, cap):
    names = [f"zoo:{n}" for n in ZOO_MIX] + ["trace:mm_tile",
                                             "trace:vecadd"]
    jw, pw = workloads(names)
    hints = {"stencil": 5.0, "mixed": 1e6} if by == "cost" else None
    got = PB.bucket_workloads(pw, by, cap, hints)
    assert got == JB.bucket_workloads(jw, by, cap, hints)
    assert sorted(i for g in got for i in g) == list(range(len(names)))
    for j, p in zip(jw, pw):
        assert PB.workload_shape(p) == JB.workload_shape(j)
        assert PB.workload_cost(p) == JB.workload_cost(j)
        assert PB.workload_cost(p, hints) == JB.workload_cost(j, hints)


@pytest.mark.parametrize("seed", range(4))
def test_choose_bucket_count_equal(seed):
    rng = np.random.default_rng(seed)
    keys = [float(x) for x in rng.choice([1, 2, 50, 51, 900, 1000, 4e4],
                                         int(rng.integers(1, 12)))]
    for overhead in (None, 0.0, 10.0):
        assert PB.choose_bucket_count(keys, overhead) == \
            JB.choose_bucket_count(keys, overhead)


def test_bucket_policy_error():
    with pytest.raises(ValueError, match="unknown bucket policy 'size'"):
        PB.bucket_workloads(workloads(["zoo:mixed"])[1], by="size")


def test_cost_hints_from_manifests_equal(tmp_path):
    assert PT.COUNTERS == COUNTERS
    wi = COUNTERS.index("lockstep_waste")
    tl = [[0.0] * len(COUNTERS), [0.0] * len(COUNTERS)]
    tl[-1][wi] = 40.0
    (tmp_path / "a.json").write_text(json.dumps({
        "stats": [{"workload": "mixed", "cycles": 100},
                  {"workload": "stencil", "cycles": "x"}],
        "timelines": {"mixed/0": tl}}))
    (tmp_path / "b.json").write_text(json.dumps({
        "stats": [{"workload": "mixed", "cycles": 120}, 7]}))
    (tmp_path / "junk.json").write_text("{not json")
    got = PB.cost_hints_from_manifests(str(tmp_path))
    assert got == JB.cost_hints_from_manifests(str(tmp_path))
    assert got == {"mixed": 140.0}


# ---------------------------------------------------------------------------
# RunPlan
# ---------------------------------------------------------------------------

class _Mesh:
    """Stands for a device mesh: only its axis names are read."""

    def __init__(self, *names):
        self.axis_names = names


BAD_KNOBS = [dict(mode="shard"), dict(exchange="bogus"),
             dict(bucket_by="size"), dict(layout="flat"),
             dict(max_cycles=0), dict(max_buckets=0),
             dict(telemetry_samples=-1), dict(telemetry_every=0),
             dict(search_seed=-1), dict(search_rounds=0),
             dict(search_topk=0), dict(mesh=_Mesh("x")),
             dict(mesh=_Mesh("cfg", "sm"), mode="seq")]


@pytest.mark.parametrize("kw", range(len(BAD_KNOBS)))
def test_runplan_errors_equal(kw):
    kw = BAD_KNOBS[kw]
    with pytest.raises(ValueError) as want:
        JPLAN.RunPlan(**kw)
    with pytest.raises(ValueError) as got:
        PPLAN.RunPlan(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,slice_", [
    pytest.param(dict(cache_dir="/tmp/x"), "graph cache",
                 id="kw1-graph cache")])
def test_later_slices_raise_by_name(kw, slice_):
    JPLAN.RunPlan(**kw)                                 # the reference runs
    with pytest.raises(NotImplementedError, match=slice_):
        PPLAN.RunPlan(**kw)


def test_runplan_takes_a_mesh():
    """A ('cfg','sm') mesh is accepted and described as the reference's
    RunPlan describes a mesh of the same shape."""
    from repro_torch.core.distribute import make_mesh
    got = PPLAN.RunPlan(mesh=make_mesh(1, 2, device="cpu"))
    mesh = _Mesh("cfg", "sm")
    mesh.shape = {"cfg": 1, "sm": 2}
    assert got.describe() == JPLAN.RunPlan(mesh=mesh).describe()
    assert got.describe()["mesh"] == [1, 2]


def test_shard_runner_and_launchers_take_a_mesh(capsys):
    """The shard SM runner steps a workload through the engine equal to
    the golden, and both launchers run on a CPU mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    with open(GOLDEN) as f:
        want = json.load(f)["trace:gather_chain@1.0"]
    runner = make_sm_runner(PC.TINY, "shard",
                            make_host_mesh(2, device="cpu"))
    got = S.finalize(simulate(PZ.resolve_workload("trace:gather_chain"),
                              PC.TINY, runner, max_cycles=MAX_CYCLES,
                              device="cpu"))
    assert S.comparable(got) == want
    dse.main(["--workload", "nn", "--scale", "0.02", "--n", "2", "--mesh",
              "1", "2", "--device", "cpu", "--no-manifest"])
    assert "on 1x2 ('cfg','sm') mesh" in capsys.readouterr().out
    zoo.main(["--trace", TRACES, "--grid", "1", "2", "--mesh", "2", "1",
              "--device", "cpu", "--no-manifest"])
    assert "on 2x1 ('cfg','sm') mesh" in capsys.readouterr().out


def test_runplan_defaults_and_describe():
    got, want = PPLAN.RunPlan(), JPLAN.RunPlan()
    assert got.describe() == want.describe()
    plan = dict(bucket_by="cost", layout="ragged", max_buckets=2)
    assert PPLAN.RunPlan(**plan).describe() == \
        JPLAN.RunPlan(**plan).describe()
    json.dumps(PPLAN.RunPlan(**plan).describe())


def test_resolve_plan_equal(monkeypatch):
    for mod in (JPLAN, PPLAN):
        with pytest.raises(ValueError, match="not both"):
            mod.resolve_plan(mod.RunPlan(), where="sweep", max_cycles=64)
        with pytest.raises(TypeError, match="must be a RunPlan"):
            mod.resolve_plan({"max_cycles": 64}, where="sweep")
        assert mod.resolve_plan("seq", where="sweep").mode == "seq"
        with pytest.raises(ValueError, match="mode given twice"):
            mod.resolve_plan("seq", where="sweep", mode="vmap")
        monkeypatch.setattr(mod, "_warned_legacy", False)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p = mod.resolve_plan(None, where="sweep", max_cycles=64,
                                 mode="seq")
            mod.resolve_plan(None, where="sweep", max_cycles=64)
        assert (p.max_cycles, p.mode) == (64, "seq")
        deps = [w for w in caught
                if issubclass(w.category, DeprecationWarning)]
        assert len(deps) == 1


# ---------------------------------------------------------------------------
# padding is inert; early exit
# ---------------------------------------------------------------------------

SCFG, DYN = PC.split_config(PC.TINY, device="cpu")
RUNNER = make_sm_runner(PC.TINY, "vmap")


def run_stacked(stacked, max_cycles=MAX_CYCLES, n_lanes=1):
    return run_workload_stacked(
        init_state(SCFG, "cpu", n_lanes),
        {f: v.expand(n_lanes, *v.shape) for f, v in stacked.items()}, SCFG,
        DYN.map(lambda x: x.expand(n_lanes, *x.shape)), RUNNER, max_cycles)


def test_padded_equals_unpadded():
    w = PZ.zoo_workload("reduction_tree", scale=SCALE)
    packed = [k.pack("cpu") for k in w.kernels]
    plain = run_stacked(PB.stack_kernels(packed))
    n_instr = max(k.n_instr for k in w.kernels)
    padded = run_stacked(PB.stack_kernels(packed, n_instr=n_instr + 13,
                                          n_kernels=len(packed) + 3))
    a = S.finalize(S.take_lane(plain, 0))
    b = S.finalize(S.take_lane(padded, 0))
    assert S.comparable(a) == S.comparable(b)
    assert a["timeouts"] == b["timeouts"] == 0


def test_all_empty_lane_contributes_zero():
    """Two lanes of nothing but pad kernels: 0 cycles, 0 timeouts, and
    the state untouched."""
    out = run_stacked(PB.stack_kernels([PB.empty_packed(8, "cpu")] * 4),
                      n_lanes=2)
    assert out["ctrl"]["total_cycles"].tolist() == [0, 0]
    assert out["ctrl"]["timeouts"].tolist() == [0, 0]
    init = init_state(SCFG, "cpu", 2)
    for part in ("warp", "sm", "req", "mem", "stats_sm", "stats"):
        for k, v in init[part].items():
            assert torch.equal(v, out[part][k]), (part, k)


def test_timeout_flag_reported():
    w = PZ.zoo_workload("random_gather", scale=SCALE)
    cut = S.finalize(simulate(w, PC.TINY, RUNNER, max_cycles=PC.TINY.quantum,
                              device="cpu"))
    assert cut["timeout"] and cut["timeouts"] >= 1


def test_empty_kernel_runs_zero_quanta():
    """Early exit: a padding kernel in one lane is converged at entry and
    charges zero quanta, while a real kernel in the other lane runs."""
    w = PZ.zoo_workload("streaming_copy", scale=SCALE)
    tr = w.kernels[0].pack("cpu")
    lanes = {f: torch.stack([v, v]) for f, v in tr.items()}
    lanes["n_ctas"] = torch.tensor([0, int(tr["n_ctas"])], dtype=torch.int32)
    dyn = DYN.map(lambda x: x.expand(2, *x.shape))
    st = init_state(SCFG, "cpu", 2)
    entry = mark_entry_converged(st, lanes)
    assert entry["ctrl"]["done_cycle"].tolist() == [0, -1]
    out = run_kernel(st, lanes, SCFG, dyn, RUNNER, max_cycles=MAX_CYCLES)
    assert out["ctrl"]["cycle"][0] == 0 and out["ctrl"]["done_cycle"][0] == 0
    assert out["ctrl"]["done_cycle"][1] > 0
    slow = run_kernel(init_state(SCFG, "cpu"),
                      {f: v[:1] for f, v in lanes.items()}, SCFG,
                      DYN.map(lambda x: x[None]), RUNNER,
                      max_cycles=MAX_CYCLES, early_exit=False)
    assert slow["ctrl"]["cycle"][0] > 0


# ---------------------------------------------------------------------------
# lanes: L lanes at once equal L one-lane calls
# ---------------------------------------------------------------------------

N_LANES = 3


def lane_dyns(rng, n):
    """Per-lane flat dynamic overrides (memory-side latencies vary)."""
    return [{"l2_lat": int(rng.integers(8, 64)),
             "part_lat": int(rng.integers(2, 16)),
             "dram_burst": int(rng.integers(1, 8)),
             "dram_row_penalty": int(rng.integers(4, 48)),
             "icnt_lat": int(rng.integers(16, 32))} for _ in range(n)]


def one_lane(tree, i):
    return {k: v[i:i + 1] for k, v in tree.items()}


@pytest.mark.parametrize("seed", range(3))
def test_mem_phase_lanes_equal_one_lane_calls(seed):
    rng = np.random.default_rng(40 + seed)
    jscfg = JC.static_part(JC.TINY)
    t0s = [int(rng.integers(1, 40)) * jscfg.quantum + 3 * i
           for i in range(N_LANES)]
    ins = [random_mem_inputs(rng, t0, addr_hi=512, random_mem=True)
           for t0 in t0s]
    ids = [rng.permutation(jscfg.n_sm).astype(np.int32)
           for _ in range(N_LANES)]
    over = lane_dyns(rng, N_LANES)
    dyn = PC.DynConfig.stack([PC.split_config(PC.TINY, o, device="cpu")[1]
                              for o in over])
    args = [to_torch(stack_lanes([x[j] for x in ins]), "cpu")
            for j in range(3)]
    t0 = torch.tensor(t0s, dtype=torch.int32)
    sm_ids = torch.as_tensor(np.stack(ids))
    got = PM.mem_phase(*args, t0, SCFG, dyn, sm_ids=sm_ids)
    for i in range(N_LANES):
        one = PM.mem_phase(*(one_lane(a, i) for a in args), t0[i:i + 1],
                           SCFG, dyn.map(lambda x: x[i:i + 1]),
                           sm_ids=sm_ids[i:i + 1])
        jdyn = JC.split_config(JC.TINY, over[i])[1]
        want = J_MEM_PHASE(*(jax.tree_util.tree_map(jnp.asarray, x)
                             for x in ins[i]), jnp.int32(t0s[i]), jscfg,
                           jdyn, sm_ids=jnp.asarray(ids[i]))
        for g, o, w in zip(got, one, want):
            for k in g:
                assert torch.equal(g[k][i:i + 1], o[k]), k
            assert_same(w, {k: v[i] for k, v in g.items()})
    # the lanes differ: something was served
    assert int(sum(got[2]["l2_hit"] + got[2]["l2_miss"])) > 0


@pytest.mark.parametrize("cfg", ["TINY", "RTX3080TI"])
@pytest.mark.parametrize("seed", range(2))
def test_cta_issue_lanes_equal_one_lane_calls(cfg, seed):
    rng = np.random.default_rng(60 + seed)
    jscfg = JC.static_part(getattr(JC, cfg))
    pscfg = PC.static_part(getattr(PC, cfg))
    ins = [random_cta_inputs(rng, jscfg) for _ in range(N_LANES)]
    args = [to_torch(stack_lanes([x[j] for x in ins]), "cpu")
            for j in range(4)]
    got = PCTA.cta_issue(*args, pscfg)
    for i in range(N_LANES):
        one = PCTA.cta_issue(*(one_lane(a, i) for a in args), pscfg)
        want = jax.jit(JCTA.cta_issue, static_argnums=(4,))(
            *jax.tree_util.tree_map(jnp.asarray, ins[i]), jscfg)
        for g, o, w in zip(got, one, want):
            for k in g:
                assert torch.equal(g[k][i:i + 1], o[k]), k
            assert_same(w, {k: v[i] for k, v in g.items()})


@partial(jax.jit, static_argnums=(5,))
def _reference_quantum(warp, sm, req, stats_sm, trace, cfg, dyn, t0):
    return JP.make_sm_runner(cfg, "vmap")(warp, sm, req, stats_sm, trace,
                                          t0, dyn)


@pytest.mark.parametrize("mode", ["vmap", "seq"])
@pytest.mark.parametrize("ragged", [False, True])
def test_sm_phase_lanes_equal_one_lane_calls(mode, ragged):
    """The eager SM phase over lanes with their own state, trace,
    ``instr_base``, dynamic config and clock equals one-lane calls, and
    each lane the reference's quantum."""
    rng = np.random.default_rng(80 + ragged)
    jscfg = JC.static_part(JC.TINY)
    host, t0s, over = random_lane_inputs(rng, SCFG, N_LANES, ragged=ragged)
    dyn = PC.DynConfig.stack([PC.split_config(PC.TINY, o, device="cpu")[1]
                              for o in over])
    args = [to_torch(x, "cpu") for x in host]
    t0 = torch.as_tensor(t0s)
    runner = make_sm_runner(PC.TINY, mode)
    got = runner(*args, t0, dyn)
    for i in range(N_LANES):
        one = smcore.sm_quantum_eager(*(one_lane(a, i) for a in args),
                                      t0[i:i + 1], SCFG,
                                      dyn.map(lambda x: x[i:i + 1]))
        jdyn = JC.split_config(JC.TINY, over[i])[1]
        want = _reference_quantum(
            *(jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), h)
              for h in host), jscfg, jdyn, jnp.int32(t0s[i]))
        for g, o, w in zip(got, one, want):
            for k in g:
                assert torch.equal(g[k][i:i + 1], o[k]), k
            assert_same(w, {k: v[i] for k, v in g.items()})
    # the lanes issue, and differently
    issued = got[3]["issued"].sum(1) - args[3]["issued"].sum(1)
    assert (issued > 0).all() and len(set(issued.tolist())) > 1
