"""The port's CUDA path, on the card: the sm_issue, sm_quantum, wkv6 and
flash_attention kernels against their plain PyTorch versions, the
wrappers' input checks and launch counts, simulations on the card against
the same simulations on the CPU and against the golden stats, counter
timelines against their golden file and the CPU, the seeded search on the
card against the same search on the CPU, the simulation server on the card
against solo card runs and the golden stats, the first build of a kernel
from two threads, SM-axis shards and a 2×2 ('cfg','sm') grid on a mesh
that repeats the card, the simulator's kernels launched on a second card
(skipped with one), the reduced RWKV-6 and dense models on the card
against their golden files, the backward kernels (wkv6_bwd,
flash_attention_bwd) against their plain versions in f64 and autograd,
the autograd Functions over the kernels, and reduced models training on
the card (launch counts, gradients against the plain versions, a
checkpoint restart bit for bit), the reduced jamba and whisper-base
against their golden file, and non-causal attention with more queries
than keys.

Every test here carries the `cuda` marker and skips without a CUDA card.
This file imports neither jax nor repro, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import (QUANTUM_T0, jitter_constant_leaves,
                                 lm_params_to_torch, params_fingerprint,
                                 random_lane_inputs, random_quantum_inputs,
                                 seeded_lm_params, stack_lanes, to_numpy,
                                 to_torch)
from repro_torch.core import engine
from repro_torch.core import stats as S
from repro_torch.core import telemetry as T
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.search import SearchSpace, search
from repro_torch.core.sweep import grid_sweep, sweep
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ref import _scores, attention_plain
from repro_torch.kernels.sm_issue import kernel as K
from repro_torch.kernels.sm_quantum import kernel as Q
from repro_torch.kernels.wkv6 import kernel as W
from repro_torch.kernels.wkv6.ref import wkv_ref_stepwise
from repro_torch.models import factory
from repro_torch.models.lm import LM
from repro_torch.sim.config import (N_CLASSES, N_UNITS, RTX3080TI,
                                    SCHEDULERS, TINY, DynConfig,
                                    split_config, static_part)
from repro_torch.sim.smcore import sm_quantum_eager
from repro_torch.sim.workloads import resolve_workload

pytestmark = pytest.mark.cuda

# (n_sm, warps per SM, sub-cores): TINY, RTX 3080 Ti, and odd widths
SHAPES = ((8, 8, 2), (80, 48, 4), (4, 16, 4), (3, 96, 3))


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "torch_port_rwkv6_reduced.json")
SIM_GOLDENS = {TINY: "determinism_tiny.json",
               RTX3080TI: "torch_port_rtx3080ti.json"}
DENSE_GOLDEN = os.path.join(os.path.dirname(GOLDEN),
                            "torch_port_dense_reduced.json")
MOE_GOLDEN = os.path.join(os.path.dirname(GOLDEN),
                          "torch_port_moe_reduced.json")
HYBRID_GOLDEN = os.path.join(os.path.dirname(GOLDEN),
                             "torch_port_hybrid_reduced.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products stay f32
    return torch.device("cuda")


def random_inputs(rng, ns, w, sc, device):
    """Full-contract inputs: barrier waits, LRR or GTO, a ragged
    instr_base, n_instr < len(ops)."""
    n_ops, t = 32, 200
    base = int(rng.integers(0, 6))
    n_instr = int(rng.integers(0, n_ops - base + 1))
    host = (
        rng.integers(0, n_instr + 2, (ns, w)).astype(np.int32),
        rng.random((ns, w)) < 0.8,
        rng.integers(t - 10, t + 6, (ns, w)).astype(np.int32),
        rng.integers(0, 3, (ns, w)).astype(np.int32),
        rng.random((ns, w)) < 0.3,
        rng.random((ns, w)) < 0.25,
        rng.integers(-1, w, (ns, sc)).astype(np.int32),
        rng.integers(t - 4, t + 4, (ns, sc, N_UNITS)).astype(np.int32),
        rng.integers(0, N_CLASSES, n_ops).astype(np.int32))
    scalars = (n_instr, base, int(rng.integers(0, 2)), t)
    return ([torch.as_tensor(x, device=device) for x in host]
            + [torch.tensor(v, dtype=torch.int32, device=device)
               for v in scalars])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, seed):
    ns, w, sc = shape
    args = random_inputs(np.random.default_rng(seed), ns, w, sc, cuda)
    before = K.issue_select.launches
    got = K.issue_select(*args, n_subcores=sc)
    assert K.issue_select.launches == before + 1
    want = K.issue_select_plain(*args, n_subcores=sc)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_wrapper_rejects_bad_inputs(cuda):
    args = random_inputs(np.random.default_rng(0), 8, 8, 2, cuda)
    bad_dtype = list(args)
    bad_dtype[0] = args[0].long()
    with pytest.raises(TypeError, match="pc"):
        K.issue_select(*bad_dtype, n_subcores=2)
    strided = list(args)
    strided[2] = torch.cat([args[2], args[2]], 1)[:, ::2]
    with pytest.raises(ValueError, match="ready_at must be contiguous"):
        K.issue_select(*strided, n_subcores=2)
    on_cpu = list(args)
    on_cpu[6] = args[6].cpu()
    with pytest.raises(ValueError, match="last_issued is on cpu"):
        K.issue_select(*on_cpu, n_subcores=2)
    with pytest.raises(ValueError, match="n_subcores=3"):
        K.issue_select(*args, n_subcores=3)


class _QuantumSteps:
    """Counts the engine's quantum steps."""

    def __init__(self, monkeypatch):
        self.n = 0
        step = engine.quantum_step

        def counted(*args, **kw):
            self.n += 1
            return step(*args, **kw)
        monkeypatch.setattr(engine, "quantum_step", counted)


@pytest.mark.parametrize("cfg,bench,scale", [(TINY, "zoo:mixed", 0.01),
                                             (RTX3080TI, "nn", 0.05)])
def test_simulate_on_card_equals_cpu(cuda, monkeypatch, cfg, bench, scale):
    w = resolve_workload(bench, scale)
    steps = _QuantumSteps(monkeypatch)
    before, fused = K.issue_select.launches, Q.sm_quantum.launches
    on_card = S.finalize(simulate(w, cfg, make_sm_runner(cfg, "vmap")))
    # the SM phase is one sm_quantum launch per quantum, no sm_issue
    assert Q.sm_quantum.launches - fused == steps.n > 0
    assert K.issue_select.launches == before
    on_cpu = S.finalize(simulate(w, cfg, make_sm_runner(cfg, "vmap"),
                                 device="cpu"))
    assert S.comparable(on_card) == S.comparable(on_cpu)
    assert on_card["timeouts"] == on_cpu["timeouts"] == 0


@pytest.mark.parametrize("cfg,bench,scale,mode", [
    (TINY, "myocyte", 1.0, "vmap"), (TINY, "myocyte", 1.0, "seq"),
    (TINY, "trace:gather_chain", 1.0, "vmap"),
    (TINY, "trace:gather_chain", 1.0, "seq"),
    (RTX3080TI, "nn", 0.5, "vmap")])
def test_simulate_on_card_equals_golden(cuda, monkeypatch, cfg, bench, scale,
                                        mode):
    with open(os.path.join(os.path.dirname(GOLDEN), SIM_GOLDENS[cfg])) as f:
        want = json.load(f)[f"{bench}@{scale}"]
    steps = _QuantumSteps(monkeypatch)
    fused = Q.sm_quantum.launches
    out = S.finalize(simulate(resolve_workload(bench, scale), cfg,
                              make_sm_runner(cfg, mode),
                              max_cycles=1 << 17))
    assert S.comparable(out) == want
    assert out["timeouts"] == 0
    per_step = cfg.n_sm if mode == "seq" else 1
    assert Q.sm_quantum.launches - fused == per_step * steps.n


def test_hotspot_golden_on_card(cuda, monkeypatch):
    """The golden case ``hotspot@0.02`` on TINY at the golden's
    max_cycles = 1 << 15: all 14 counters equal the golden, and 2 of its
    4 kernels are cut by the cap.  The 2 is the JAX package's own reading
    of the same run on the CPU (``timeouts`` 2; without the cap it runs
    131,520 cycles with 0 timeouts: ROADMAP.md §3); the card has no JAX
    to ask.  Off tier-1: ~40 s on one CPU thread."""
    with open(os.path.join(os.path.dirname(GOLDEN), SIM_GOLDENS[TINY])) as f:
        want = json.load(f)["hotspot@0.02"]
    steps = _QuantumSteps(monkeypatch)
    fused = Q.sm_quantum.launches
    out = S.finalize(simulate(resolve_workload("hotspot", 0.02), TINY,
                              make_sm_runner(TINY, "vmap"),
                              max_cycles=1 << 15))
    assert S.comparable(out) == want
    assert out["timeouts"] == 2
    assert Q.sm_quantum.launches - fused == steps.n > 0


def test_grid_on_card_equals_solo_runs(cuda, monkeypatch):
    """A ragged grid of traces and a multi-kernel zoo workload on the
    card: one sm_quantum launch per quantum for all lanes together, and
    every lane equals its solo run on the card, timeouts included."""
    names = ("trace:gather_chain", "zoo:reduction_tree", "trace:vecadd")
    ws = [resolve_workload(n, 0.005 if n.startswith("zoo") else 1.0)
          for n in names]
    cfgs = [TINY, dataclasses.replace(TINY, scheduler="lrr", l2_lat=64)]
    steps = _QuantumSteps(monkeypatch)
    fused = Q.sm_quantum.launches
    grid = grid_sweep(ws, cfgs, plan=RunPlan(max_cycles=1 << 15,
                                             layout="ragged"))
    assert Q.sm_quantum.launches - fused == steps.n > 0
    for w, workload in enumerate(ws):
        for c, cfg in enumerate(cfgs):
            solo = S.finalize(simulate(workload, cfg,
                                       make_sm_runner(cfg, "vmap"),
                                       max_cycles=1 << 15))
            assert S.comparable(grid.stats[w][c]) == S.comparable(solo)
            assert grid.stats[w][c]["timeouts"] == solo["timeouts"] == 0


def _load_golden(name):
    with open(os.path.join(os.path.dirname(GOLDEN), name)) as f:
        return json.load(f)


@pytest.mark.parametrize("bench,scale", [("nn", 0.5), ("syrk", 0.16)])
def test_telemetry_golden_on_card(cuda, monkeypatch, bench, scale):
    """The full-width counter timelines on the card: every row,
    ``lockstep_waste`` and ``telemetry_samples`` equal the JAX package's
    (tests/golden/torch_port_telemetry.json), ``comparable()`` the pinned
    stats, and the last row equals ``finalize``."""
    golden = _load_golden("torch_port_telemetry.json")
    cfg = dataclasses.replace(RTX3080TI, telemetry_samples=golden["samples"],
                              telemetry_every=golden["every"])
    steps = _QuantumSteps(monkeypatch)
    fused = Q.sm_quantum.launches
    st = simulate(resolve_workload(bench, scale), cfg,
                  make_sm_runner(cfg, "vmap"),
                  max_cycles=golden["max_cycles"])
    assert Q.sm_quantum.launches - fused == steps.n > 0
    out = S.finalize(st)
    key = f"{bench}@{scale}"
    assert {"timeline": T.timeline(st).tolist(),
            "lockstep_waste": out["lockstep_waste"],
            "telemetry_samples": out["telemetry_samples"]} == \
        golden["cases"][key]
    assert S.comparable(out) == _load_golden(SIM_GOLDENS[RTX3080TI])[key]
    assert T.check_final_sample(st, out) == []


def test_sweep_timelines_on_card_equal_cpu(cuda):
    """A TINY sweep with a full timeline buffer: every lane's timeline on
    the card equals the CPU's."""
    w = resolve_workload("zoo:mixed", 0.005)
    cfgs = [TINY, dataclasses.replace(TINY, scheduler="lrr", l2_lat=64)]
    plan = RunPlan(max_cycles=1 << 14, telemetry_samples=32,
                   telemetry_every=2)
    card = sweep(w, cfgs, plan=plan)
    cpu = sweep(w, cfgs, plan=plan, device="cpu")
    for key, tl in cpu.timelines().items():
        assert np.array_equal(card.timelines()[key], tl), key
    assert [s["lockstep_waste"] for s in card.stats] == \
        [s["lockstep_waste"] for s in cpu.stats]


def test_search_card_equals_cpu(cuda, monkeypatch):
    """The seeded analytic-prune search with its verify sweeps on the card
    equals the same search on the CPU, timings apart."""
    timing = ("analytic_s", "analytic_cands_per_s", "verify_s",
              "verify_lanes_per_s")
    w = resolve_workload("nn", 0.05)
    plan = RunPlan(max_cycles=1 << 14, search_rounds=2, search_topk=4)
    kw = dict(space=SearchSpace.from_base(TINY), plan=plan, seed=7,
              base=TINY, n_candidates=48, calibrate_from=None)
    steps = _QuantumSteps(monkeypatch)
    fused = Q.sm_quantum.launches
    card = search(w, **kw)
    assert Q.sm_quantum.launches - fused == steps.n > 0
    cpu = search(w, device="cpu", **kw)
    assert card.best == cpu.best and card.best_cycles == cpu.best_cycles
    assert [(v.tolist(), c) for v, c, _ in card.verified] == \
        [(v.tolist(), c) for v, c, _ in cpu.verified]
    assert [{k: v for k, v in r.items() if k not in timing}
            for r in card.rounds] == \
        [{k: v for k, v in r.items() if k not in timing} for r in cpu.rounds]
    assert np.array_equal(card.model.theta, cpu.model.theta)


TRACE_DIR = os.path.join(os.path.dirname(GOLDEN), "..", "data", "traces")
# the card server's pool: the golden pairs, a config-override lane, a
# sample grid and an uploaded trace, each a footprint of its own
SERVE_SUBS = (
    {"id": "myocyte", "workload": "myocyte"},
    {"id": "gather", "workload": "trace:gather_chain"},
    {"id": "cfg", "workload": "zoo:reduction_tree", "scale": 0.005,
     "config": {"l2_lat": 64, "scheduler": "lrr"}},
    {"id": "grid", "workload": "trace:vecadd",
     "sample": {"n": 2, "lat": [["fp32", 2, 8]]}},
)


def _serve_subs():
    with open(os.path.join(TRACE_DIR, "mm_tile.trace")) as f:
        return SERVE_SUBS + ({"id": "upload", "trace_text": f.read()},)


def _lane_sigs(job) -> list:
    return [dict(S.comparable(s), timeouts=s["timeouts"])
            for s in job.stats]


def _solo_sigs(job) -> list:
    out = []
    for w, cfg in job.pairs:
        st = S.finalize(simulate(w, cfg, make_sm_runner(cfg, "vmap"),
                                 max_cycles=1 << 15))
        out.append(dict(S.comparable(st), timeouts=st["timeouts"]))
    return out


def test_server_on_card_equals_solo_runs_and_golden(cuda, monkeypatch):
    """A TINY server on its default device, the card, serves one batch:
    one sm_quantum launch per quantum of every bucket run, every lane
    equal to its solo card run, and the golden pairs (myocyte@1.0,
    trace:gather_chain@1.0) equal to their golden stats."""
    from repro_torch.core.service import SimService
    with open(os.path.join(os.path.dirname(GOLDEN), SIM_GOLDENS[TINY])) as f:
        golden = json.load(f)
    svc = SimService(base=TINY, plan=RunPlan(max_cycles=1 << 15,
                                             bucket_by="shape"), start=False)
    assert svc.device.type == "cuda"
    jobs = [svc.submit(s) for s in _serve_subs()]
    steps = _QuantumSteps(monkeypatch)
    fused = Q.sm_quantum.launches
    assert svc.run_pending() == len(jobs)
    assert Q.sm_quantum.launches - fused == steps.n > 0
    assert jobs[0].batch["n_buckets"] > 1
    assert S.comparable(jobs[0].stats[0]) == golden["myocyte@1.0"]
    assert S.comparable(jobs[1].stats[0]) == \
        golden["trace:gather_chain@1.0"]
    for job in jobs:
        assert _lane_sigs(job) == _solo_sigs(job), job.id
        json.dumps(job.response())


def test_threaded_server_on_card(cuda):
    """The scheduler thread runs every batch on the card while two client
    threads submit; after drain, every lane equals its solo card run."""
    import threading
    from repro_torch.core.service import SimService
    svc = SimService(base=TINY, plan=RunPlan(max_cycles=1 << 15,
                                             bucket_by="shape"),
                     batch_lanes=3, max_wait_s=0.02)
    subs = _serve_subs()[1:]
    jobs, lock = [], threading.Lock()

    def client(ci):
        for j in range(2):
            job = svc.submit(dict(subs[(ci + j) % len(subs)],
                                  id=f"c{ci}-{j}"))
            with lock:
                jobs.append(job)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert svc.drain(timeout=300.0), svc.stats()
    svc.shutdown(drain=False)
    assert svc.stats()["served"] == 4 and svc.stats()["errors"] == 0
    for job in jobs:
        assert _lane_sigs(job) == _solo_sigs(job), job.id


def test_kernel_first_build_from_two_threads(cuda, tmp_path, monkeypatch):
    """Two threads reach sm_quantum's first build at once: nvcc runs once,
    one library is installed with its ptxas log beside it and both
    threads load it; a launcher made with ``build.once`` hands both
    threads the same one."""
    import threading
    from repro_torch.kernels import build

    def together(fn):
        barrier = threading.Barrier(2)
        out = [None, None]

        def run(i):
            barrier.wait()
            out[i] = fn()
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        return out

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "a")
    built = together(lambda: build.build_library(Q.SOURCE, "sm_quantum"))
    assert sorted(info["seconds"] > 0 for _, info in built) == [False, True]
    name = os.path.basename(built[0][1]["path"])
    assert sorted(os.listdir(tmp_path / "a")) == [name, name + ".log"]
    assert "registers" in built[0][1]["log"]
    assert built[0][1]["log"] == built[1][1]["log"]
    assert all(hasattr(lib, "sm_quantum_launch") for lib, _ in built)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    launcher = build.once(lambda: build.build_library(Q.SOURCE,
                                                      "sm_quantum"))
    first = together(launcher)
    assert first[0] is first[1]
    assert sorted(os.listdir(tmp_path / "b")) == [name, name + ".log"]


SC4 = dict(n_sm=4, warps_per_sm=16, n_subcores=4, mshr_per_sm=6)
QUANTUM_CFGS = {"tiny": TINY, "four_subcores": dataclasses.replace(TINY,
                                                                   **SC4),
                "rtx3080ti": RTX3080TI}


def _tiny_golden():
    with open(os.path.join(os.path.dirname(GOLDEN),
                           SIM_GOLDENS[TINY])) as f:
        return json.load(f)


def _one_card(n):
    """A mesh position list that repeats the current card ``n`` times."""
    return [torch.device("cuda", torch.cuda.current_device())] * n


@pytest.mark.parametrize("bench,n_dev,policy,exchange", [
    ("myocyte", 4, "static", "window"),
    ("trace:gather_chain", 4, "dynamic", "cycle")])
def test_shard_on_repeated_card_equals_golden(cuda, bench, n_dev, policy,
                                              exchange):
    """SM-axis sharding over a 1-D mesh that repeats the card: the golden
    stats; window exchange launches sm_quantum once per block per quantum
    and no sm_issue, cycle exchange sm_issue once per block per cycle."""
    from repro_torch.core.engine import run_workload
    from repro_torch.core.parallel import (permute_state, run_kernel_sharded,
                                           sm_permutation)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sim.state import init_state
    scfg, dyn = split_config(TINY, device=cuda)
    mesh = make_host_mesh(n_dev, devices=_one_card(n_dev))
    w = resolve_workload(bench, 1.0)
    before, fused = K.issue_select.launches, Q.sm_quantum.launches
    st = run_workload(
        permute_state(init_state(scfg, cuda, 1),
                      sm_permutation(TINY, n_dev, policy)),
        [k.pack(cuda) for k in w.kernels], scfg, dyn,
        kernel_runner=lambda s, k, d: run_kernel_sharded(
            s, k, TINY, mesh, max_cycles=1 << 15, exchange=exchange, dyn=d))
    out = S.finalize(S.take_lane(st, 0))
    assert S.comparable(out) == _tiny_golden()[f"{bench}@1.0"]
    assert out["timeouts"] == 0
    quanta = out["cycles"] // TINY.quantum
    if exchange == "window":
        assert Q.sm_quantum.launches - fused == n_dev * quanta
        assert K.issue_select.launches == before
    else:
        assert Q.sm_quantum.launches == fused
        assert K.issue_select.launches > before


def test_grid_on_one_repeated_card_2x2_equals_nomesh(cuda):
    """A 2×2 ('cfg','sm') mesh that repeats the card at every position:
    every lane of a grid, its timeline included, equals the no-mesh grid
    on the card; sm_quantum launches come in one per block per quantum."""
    from repro_torch.core.distribute import make_mesh
    names = ("trace:gather_chain", "zoo:reduction_tree", "trace:vecadd")
    ws = [resolve_workload(n, 0.005 if n.startswith("zoo") else 1.0)
          for n in names]
    cfgs = [TINY, dataclasses.replace(TINY, scheduler="lrr", l2_lat=64)]
    plan = dict(max_cycles=1 << 15, telemetry_samples=16, telemetry_every=2)
    ref = grid_sweep(ws, cfgs, plan=RunPlan(**plan))
    fused = Q.sm_quantum.launches
    got = grid_sweep(ws, cfgs, plan=RunPlan(
        mesh=make_mesh(2, 2, devices=_one_card(4)), **plan))
    launches = Q.sm_quantum.launches - fused
    assert launches > 0 and launches % 2 == 0
    for w in range(len(ws)):
        for c in range(len(cfgs)):
            for s in (got.stats[w][c], ref.stats[w][c]):
                assert s["timeouts"] == 0
            assert S.comparable(got.stats[w][c]) == \
                S.comparable(ref.stats[w][c])
    tls = ref.timelines()
    for key, tl in got.timelines().items():
        assert np.array_equal(tl, tls[key]), key


def test_kernels_launch_on_their_tensors_device(cuda):
    """sm_issue and sm_quantum on tensors of a second card while the
    first is current: each launches on its tensors' card (sm_quantum sets
    its shared-memory attribute there first) and equals its plain
    version; then a 1-D mesh over two distinct cards gives the golden
    stats."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card: launches on cuda:1 while "
                    "cuda:0 is current")
    other = torch.device("cuda", 1)
    rng = np.random.default_rng(11)
    with torch.cuda.device(0):
        args = random_inputs(rng, 80, 48, 4, other)
        got = K.issue_select(*args, n_subcores=4)
        want = K.issue_select_plain(*args, n_subcores=4)
        for g, r in zip(got, want):
            assert g.device == other and torch.equal(g, r)
        # an SM state above the 48 KB a block gets without
        # cudaFuncSetAttribute, so the attribute is set on cuda:1
        cfg = dataclasses.replace(RTX3080TI, addrset_cap=8192, l1_sets=256)
        assert Q.shared_bytes(static_part(cfg)) > 48 * 1024
        host = random_quantum_inputs(rng, static_part(cfg))
        outs = []
        for dev in ("cpu", other):
            _, dyn = split_config(cfg, device=dev)
            outs.append(make_sm_runner(cfg, "vmap")(
                *[to_torch(stack_lanes([x]), dev) for x in host],
                torch.tensor([QUANTUM_T0], dtype=torch.int32, device=dev),
                dyn.map(lambda x: x[None])))
        for want, got in zip(*outs):
            for k in want:
                assert got[k].device == other
                assert np.array_equal(to_numpy(got[k]), to_numpy(want[k])), k
    from repro_torch.launch.mesh import make_host_mesh
    w = resolve_workload("myocyte", 1.0)
    out = S.finalize(simulate(w, TINY, make_sm_runner(
        TINY, "shard", make_host_mesh(2)), max_cycles=1 << 15))
    assert S.comparable(out) == _tiny_golden()["myocyte@1.0"]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("sched", ["gto", "lrr"])
@pytest.mark.parametrize("mode", ["seq", "vmap"])
@pytest.mark.parametrize("name", list(QUANTUM_CFGS))
def test_sm_quantum_equals_eager(cuda, name, mode, sched, ragged):
    """The fused kernel against the eager SM phase on CPU copies of the
    same seeded state (one lane), leaf for leaf; the card's inputs stay
    as they were."""
    cfg = QUANTUM_CFGS[name]
    host = random_quantum_inputs(np.random.default_rng(7), static_part(cfg),
                                 ragged=ragged)
    outs, launches = [], []
    for dev in ("cpu", cuda):
        _, dyn = split_config(cfg, {"sched": SCHEDULERS[sched]}, device=dev)
        args = [to_torch(stack_lanes([x]), dev) for x in host]
        before = Q.sm_quantum.launches
        outs.append(make_sm_runner(cfg, mode)(
            *args, torch.tensor([QUANTUM_T0], dtype=torch.int32, device=dev),
            dyn.map(lambda x: x[None])))
        launches.append(Q.sm_quantum.launches - before)
        for x, a in zip(host, args):
            for k in x:
                assert np.array_equal(np.asarray(x[k]),
                                      a[k][0].cpu().numpy())
    assert launches == [0, cfg.n_sm if mode == "seq" else 1]
    for want, got in zip(*outs):
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(to_numpy(got[k]), to_numpy(want[k])), k
    # the seeded state issues, hits and misses in L1 and releases barriers
    # (the four-sub-core state without instr_base hits no line it warmed:
    # the eager loop gives it no L1 hit either)
    keys = ["issued", "issued_mem", "l1_miss"]
    if name != "four_subcores" or ragged:
        keys.append("l1_hit")
    for k in keys:
        assert (outs[1][3][k][0].cpu() > torch.as_tensor(host[3][k])).any(), k
    assert (~outs[1][0]["wait_bar"][0].cpu()
            & torch.as_tensor(host[0]["wait_bar"])).any()


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", list(QUANTUM_CFGS))
def test_sm_quantum_lanes_equal_one_lane_launches(cuda, name, ragged):
    """One launch over four lanes, each with its own state, trace,
    instr_base, dynamic config and clock, equals the eager SM phase over
    the same lanes on the card, and four one-lane launches, leaf for
    leaf."""
    cfg = QUANTUM_CFGS[name]
    scfg = static_part(cfg)
    host, t0s, over = random_lane_inputs(np.random.default_rng(11), scfg, 4,
                                         ragged=ragged)
    dyn = DynConfig.stack([split_config(cfg, o, device=cuda)[1]
                           for o in over])
    args = [to_torch(x, cuda) for x in host]
    t0 = torch.as_tensor(t0s, device=cuda)
    before = Q.sm_quantum.launches
    got = Q.sm_quantum(*args, t0, scfg, dyn)
    assert Q.sm_quantum.launches == before + 1
    eager = sm_quantum_eager(*args, t0, scfg, dyn)
    ones = [Q.sm_quantum(*({k: v[i:i + 1] for k, v in a.items()}
                           for a in args), t0[i:i + 1], scfg,
                         dyn.map(lambda x: x[i:i + 1])) for i in range(4)]
    for j in range(4):
        for k in got[j]:
            assert torch.equal(got[j][k], eager[j][k]), k
            assert torch.equal(got[j][k],
                               torch.cat([o[j][k] for o in ones])), k
    issued = got[3]["issued"].sum(1) - args[3]["issued"].sum(1)
    assert (issued > 0).all()


def test_sm_quantum_wrapper_rejects_bad_inputs(cuda):
    cfg = static_part(TINY)
    host = random_quantum_inputs(np.random.default_rng(0), cfg)
    _, dyn = split_config(TINY, device=cuda)
    dyn = dyn.map(lambda x: x[None])
    warp, sm, req, stats, trace = (to_torch(stack_lanes([x]), cuda)
                                   for x in host)
    t0 = torch.tensor([QUANTUM_T0], dtype=torch.int32, device=cuda)
    before = Q.sm_quantum.launches
    with pytest.raises(TypeError, match="warp.pc has dtype torch.int64"):
        Q.sm_quantum(dict(warp, pc=warp["pc"].long()), sm, req, stats, trace,
                     t0, cfg, dyn)
    strided = torch.cat([req["t"], req["t"]], 2)[..., ::2]
    with pytest.raises(ValueError, match="req.t must be contiguous"):
        Q.sm_quantum(warp, sm, dict(req, t=strided), stats, trace, t0, cfg,
                     dyn)
    with pytest.raises(ValueError, match="sm.l1_tag is on cpu"):
        Q.sm_quantum(warp, dict(sm, l1_tag=sm["l1_tag"].cpu()), req, stats,
                     trace, t0, cfg, dyn)
    with pytest.raises(ValueError, match="sm.addrset has shape"):
        Q.sm_quantum(warp, dict(sm, addrset=sm["addrset"][..., :-1]), req,
                     stats, trace, t0, cfg, dyn)
    with pytest.raises(ValueError, match="t0 has shape"):
        Q.sm_quantum(warp, sm, req, stats, trace, t0[0], cfg, dyn)
    with pytest.raises(ValueError, match="trace.ops must be contiguous"):
        Q.sm_quantum(warp, sm, req, stats, dict(
            trace, ops=torch.cat([trace["ops"], trace["ops"]], 1)[:, ::2]),
            t0, cfg, dyn)
    with pytest.raises(ValueError, match="t0 is on cpu"):
        Q.sm_quantum(warp, sm, req, stats, trace, t0.cpu(), cfg, dyn)
    wide = dataclasses.replace(cfg, n_subcores=33)
    with pytest.raises(ValueError, match="n_subcores=33"):
        Q.sm_quantum(warp, sm, req, stats, trace, t0, wide, dyn)
    assert Q.sm_quantum.launches == before


# ---------------------------------------------------------------------------
# wkv6
# ---------------------------------------------------------------------------

# (B, S, H, hs): the reduced model's head size, test_kernels.py's, the
# published one, ragged lengths (within a chunk and over several), one token
WKV_SHAPES = ((2, 128, 4, 16), (2, 64, 2, 32), (2, 128, 2, 64),
              (3, 37, 5, 64), (2, 100, 3, 32), (2, 1, 2, 16))


def wkv_inputs(rng, b, s, h, hs, device, zero_state, decay="random"):
    """tests/test_kernels.py's distributions (log decay -exp(N - 1)), or a
    log decay about -20 ("strong") or -1e-6 ("weak") on every token."""
    f = np.float32
    shp = (b, s, h, hs)
    host = [(0.5 * rng.standard_normal(shp)).astype(f) for _ in range(3)]
    z = rng.standard_normal(shp)
    host.append({"random": -np.exp(z - 1), "strong": -20 * np.exp(0.05 * z),
                 "weak": -1e-6 * np.exp(0.3 * z)}[decay].astype(f))
    host.append((0.3 * rng.standard_normal((h, hs))).astype(f))
    host.append(np.zeros((b, h, hs, hs), f) if zero_state else
                (0.5 * rng.standard_normal((b, h, hs, hs))).astype(f))
    return [torch.as_tensor(x, device=device) for x in host]


@pytest.mark.parametrize("decay", ["random", "strong", "weak"])
@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_kernel_matches_plain(cuda, shape, zero_state, decay):
    """Against wkv6_plain in one chunk of S (ragged lengths included), or
    under strong decay in chunks of 1, where the chunked form's own f32
    rounding is above the tolerance (ROADMAP §3, F5); and against the
    recurrence in f64."""
    args = wkv_inputs(np.random.default_rng(sum(shape)), *shape, cuda,
                      zero_state, decay)
    before = W.wkv6.launches
    got = W.wkv6(*args, chunk=shape[1])
    assert W.wkv6.launches == before + 1
    want = W.wkv6_plain(*args, chunk=1 if decay == "strong" else shape[1])
    truth = wkv_ref_stepwise(*(a.double() for a in args))
    torch.cuda.synchronize()
    for g, r, t in zip(got, want, truth):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g.double(), t, rtol=1e-4, atol=1e-4)


def test_wkv6_wrapper_rejects_bad_inputs(cuda):
    args = wkv_inputs(np.random.default_rng(0), 2, 8, 2, 16, cuda, False)
    before = W.wkv6.launches
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="r has dtype torch.float64"):
        W.wkv6(*bad)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError, match="state is on cpu"):
        W.wkv6(*bad)
    bad = list(args)
    bad[4] = args[4][:1]
    with pytest.raises(ValueError, match="u has shape"):
        W.wkv6(*bad)
    bad = list(args)
    bad[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="v must be contiguous"):
        W.wkv6(*bad)
    odd = wkv_inputs(np.random.default_rng(1), 1, 8, 2, 48, cuda, False)
    with pytest.raises(ValueError, match="head size 48"):
        W.wkv6(*odd)
    bad = list(args)
    bad[3] = torch.empty(args[3].numel() + 1, device=cuda)[1:].view(
        args[3].shape).copy_(args[3])
    with pytest.raises(ValueError, match="wlog must start on a 16-byte"):
        W.wkv6(*bad)
    assert W.wkv6.launches == before


def test_wkv6_counts_kernel_launches_only(cuda):
    args = wkv_inputs(np.random.default_rng(2), 1, 16, 2, 32, cuda, True)
    before = W.wkv6.launches
    W.wkv6(*args)
    W.wkv6(*args)
    assert W.wkv6.launches == before + 2
    W.wkv6(*(a.cpu() for a in args))
    assert W.wkv6.launches == before + 2


def test_rwkv6_reduced_golden_on_card(cuda):
    with open(GOLDEN) as f:
        golden = json.load(f)
    cfg = get_reduced(golden["arch"])
    tree = seeded_lm_params(cfg, golden["weight_seed"])
    assert params_fingerprint(tree) == pytest.approx(golden["weights_sum"],
                                                   rel=1e-9)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, cuda))
    prompts = torch.tensor(golden["prompt"], dtype=torch.int32, device=cuda)
    before = W.wkv6.launches
    logits, cache = factory.prefill(model, {"tokens": prompts}, cfg=cfg)
    assert W.wkv6.launches == before + cfg.n_layers
    want = torch.tensor(golden["prefill_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    tok = torch.tensor(golden["tokens"], dtype=torch.int32,
                       device=cuda)[:, :1]
    logits, _ = factory.decode(model, cache, {"tokens": tok}, cfg=cfg)
    want = torch.tensor(golden["decode_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    toks = factory.generate(model, cfg, prompts, max_new=golden["max_new"])
    assert toks.cpu().tolist() == golden["tokens"]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd): the reduced models' head size, the ragged
# prompts of the cache checks (63 and 448 tokens), Sq < Sk, one query, MHA,
# and test_kernels.py's head sizes
FLASH_SHAPES = ((2, 24, 24, 4, 2, 16), (2, 63, 63, 4, 1, 32),
                (1, 448, 448, 8, 2, 128), (2, 37, 100, 4, 4, 64),
                (3, 1, 1, 4, 2, 128), (1, 1, 77, 6, 3, 64))
FLASH_TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def flash_inputs(seed, b, sq, sk, h, kv, hd, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, shape, dtype, causal):
    q, k, v = flash_inputs(sum(shape), *shape, dtype, cuda)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q, k, v = flash_inputs(0, 2, 8, 8, 4, 2, 32, torch.float32, cuda)
    before = FA.flash_attention.launches
    with pytest.raises(TypeError, match="k has dtype torch.float64"):
        FA.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError, match="q has dtype torch.float16"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="v is on cpu"):
        FA.flash_attention(q, k, v.cpu())
    with pytest.raises(ValueError, match="q must be contiguous"):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="Sq = 8 > Sk = 4"):
        FA.flash_attention(q, k[:, :4], v[:, :4])
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        FA.flash_attention(shifted, k, v)
    odd = flash_inputs(1, 1, 8, 8, 2, 1, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head size 48"):
        FA.flash_attention(*odd)
    assert FA.flash_attention.launches == before


@pytest.mark.parametrize("kv", [1, 8])
@pytest.mark.parametrize("sq,sk", [(8, 4), (100, 30), (448, 130)])
def test_flash_non_causal_more_queries_than_keys(cuda, sq, sk, kv):
    """Non-causal Sq > Sk (Whisper's cross attention when the decoder
    prompt outgrows the frames): forward and backward kernels against
    their plain versions; causal Sq > Sk still raises (F4)."""
    q, k, v = flash_inputs(sq + sk, 2, sq, sk, 8, kv, 64, torch.float32,
                           cuda)
    got = FA.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, attention_plain(q, k, v, causal=False),
                               rtol=2e-5, atol=2e-5)
    do = torch.randn_like(q)
    o, lse = FA._flash_kernel(q, k, v, False, with_lse=True)
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = FA.attention_backward_plain(q.double(), k.double(),
                                       v.double(), do.double(),
                                       causal=False)
    for g, w in zip(grads, want):
        err = (g.double() - w).abs().max() / w.abs().max()
        assert float(err) <= 1e-4
    with pytest.raises(ValueError, match=f"Sq = {sq} > Sk = {sk}"):
        FA.flash_attention(q, k, v, causal=True)


def test_flash_counts_kernel_launches_only(cuda):
    q, k, v = flash_inputs(2, 1, 16, 16, 2, 2, 16, torch.float32, cuda)
    before = FA.flash_attention.launches
    FA.flash_attention(q, k, v)
    FA.flash_attention(q, k, v, causal=False)
    assert FA.flash_attention.launches == before + 2
    FA.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert FA.flash_attention.launches == before + 2


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2-72b"])
def test_dense_reduced_golden_on_card(cuda, arch):
    with open(DENSE_GOLDEN) as f:
        golden = json.load(f)
    g = golden["archs"][arch]
    cfg = get_reduced(arch)
    tree = jitter_constant_leaves(
        seeded_lm_params(cfg, golden["weight_seed"]), golden["jitter_seed"])
    assert params_fingerprint(tree) == pytest.approx(g["weights_sum"],
                                                   rel=1e-9)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, cuda))
    prompts = torch.tensor(golden["prompt"][arch], dtype=torch.int32,
                           device=cuda)
    before = FA.flash_attention.launches
    logits, cache = factory.prefill(model, {"tokens": prompts}, cfg=cfg,
                                    max_len=golden["max_len"])
    assert FA.flash_attention.launches == before + cfg.n_layers
    want = torch.tensor(g["prefill_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    tok = torch.tensor(g["tokens"], dtype=torch.int32, device=cuda)[:, :1]
    logits, _ = factory.decode(model, cache, {"tokens": tok}, cfg=cfg)
    want = torch.tensor(g["decode_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    toks = factory.generate(model, cfg, prompts, max_new=golden["max_new"])
    assert toks.cpu().tolist() == g["tokens"]


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
def test_moe_reduced_golden_on_card(cuda, arch):
    """The reduced MoE models (arctic's std:moe; deepseek's MLA, which
    launches no kernel) against the JAX package's golden logits and
    tokens."""
    with open(MOE_GOLDEN) as f:
        golden = json.load(f)
    g = golden["archs"][arch]
    cfg = get_reduced(arch)
    tree = jitter_constant_leaves(
        seeded_lm_params(cfg, golden["weight_seed"]), golden["jitter_seed"])
    assert params_fingerprint(tree) == pytest.approx(g["weights_sum"],
                                                   rel=1e-9)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, cuda))
    prompts = torch.tensor(golden["prompt"][arch], dtype=torch.int32,
                           device=cuda)
    before = FA.flash_attention.launches
    logits, cache = factory.prefill(model, {"tokens": prompts}, cfg=cfg,
                                    max_len=golden["max_len"])
    gqa = 0 if cfg.mla is not None else cfg.n_layers
    assert FA.flash_attention.launches == before + gqa
    want = torch.tensor(g["prefill_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    tok = torch.tensor(g["tokens"], dtype=torch.int32, device=cuda)[:, :1]
    logits, _ = factory.decode(model, cache, {"tokens": tok}, cfg=cfg)
    want = torch.tensor(g["decode_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    toks = factory.generate(model, cfg, prompts, max_new=golden["max_new"])
    assert toks.cpu().tolist() == g["tokens"]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-base"])
def test_hybrid_reduced_golden_on_card(cuda, arch):
    """The reduced jamba (one period: Mamba, attention at sublayer 4, MoE
    on odd sublayers) and whisper-base (frames drawn from the golden's
    numpy seed) against the JAX package's golden logits and tokens;
    flash_attention once per period of a jamba prefill, n_enc + 2 n_dec
    times per Whisper prefill."""
    with open(HYBRID_GOLDEN) as f:
        golden = json.load(f)
    g = golden["archs"][arch]
    cfg = get_reduced(arch)
    tree = jitter_constant_leaves(
        seeded_lm_params(cfg, golden["weight_seed"],
                         max_seq=golden["max_seq"]), golden["jitter_seed"])
    assert params_fingerprint(tree) == pytest.approx(g["weights_sum"],
                                                   rel=1e-9)
    model = factory.from_state_dict(cfg, lm_params_to_torch(tree, cfg,
                                                            cuda))
    prompts = torch.tensor(golden["prompt"][arch], dtype=torch.int32,
                           device=cuda)
    batch = {"tokens": prompts}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(np.random.default_rng(
            golden["frames_seed"]).standard_normal(
            (prompts.shape[0], 1500, cfg.d_model),
            dtype=np.float32)).to(cuda)
    before = FA.flash_attention.launches
    logits, cache = factory.prefill(model, batch, cfg=cfg,
                                    max_len=golden["max_len"])
    calls = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.enc_dec
             else cfg.n_layers // len(cfg.block_pattern))
    assert FA.flash_attention.launches == before + calls
    want = torch.tensor(g["prefill_logits"], device=cuda)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    toks = [torch.argmax(logits, -1).int()[:, None]]
    for i in range(golden["max_new"] - 1):
        logits, cache = factory.decode(model, cache, {"tokens": toks[-1]},
                                       cfg=cfg)
        if i == 0:
            want = torch.tensor(g["decode_logits"], device=cuda)
            torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
        toks.append(torch.argmax(logits, -1).int()[:, None])
    assert torch.cat(toks, 1).cpu().tolist() == g["tokens"]


# ---------------------------------------------------------------------------
# backward kernels: wkv6_bwd and flash_attention_bwd
# ---------------------------------------------------------------------------

# of each gradient's largest magnitude (the CPU tests' tolerance for the
# model's gradients)
GRAD_TOL = 1e-4
WKV_BWD_SHAPES = ((2, 64, 2, 16), (2, 37, 2, 32), (1, 100, 3, 64),
                  (1, 8, 2, 64), (2, 1, 2, 16))


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("decay", ["random", "strong"])
@pytest.mark.parametrize("shape", WKV_BWD_SHAPES)
def test_wkv6_bwd_matches_plain(cuda, shape, decay):
    """The backward kernel against wkv6_backward_plain and autograd of
    wkv6_plain, both in f64 (the latter in chunks of 1 under strong decay,
    F5), with a final-state adjoint and without; one launch per call."""
    args = wkv_inputs(np.random.default_rng(sum(shape) + 7), *shape, cuda,
                      False, decay)
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s, h, hs = shape
    do = torch.randn((b, s, h, hs), generator=gen, device=cuda)
    ds = torch.randn((b, h, hs, hs), generator=gen, device=cuda)
    for dstate in (None, ds):
        before = W.wkv6_bwd.launches
        got = W.wkv6_bwd(*args, do, dstate)
        assert W.wkv6_bwd.launches == before + 1
        truth = W.wkv6_backward_plain(
            *(a.double() for a in args), do.double(),
            None if dstate is None else dstate.double())
        ins = [a.double().requires_grad_() for a in args[:5]]
        chunk = 1 if decay == "strong" else s
        o, st = W.wkv6_plain(*ins, args[5].double(), chunk=chunk)
        auto = torch.autograd.grad(
            (o, st) if dstate is not None else (o,), ins,
            (do.double(), dstate.double()) if dstate is not None
            else (do.double(),))
        torch.cuda.synchronize()
        for g, t, a in zip(got, truth, auto):
            assert torch.isfinite(g).all()
            assert rel_err(g, t) <= GRAD_TOL
            assert rel_err(g, a) <= GRAD_TOL


def test_wkv6_autograd_on_card(cuda):
    """wkv6 with inputs that require grad goes through WKV6Function: one
    forward and one backward launch; a state that requires grad raises."""
    args = wkv_inputs(np.random.default_rng(5), 2, 64, 2, 32, cuda, True)
    ins = [a.clone().requires_grad_() for a in args[:5]]
    f0, b0 = W.wkv6.launches, W.wkv6_bwd.launches
    o, _ = W.wkv6(*ins, args[5])
    (o * o).sum().backward()
    assert (W.wkv6.launches, W.wkv6_bwd.launches) == (f0 + 1, b0 + 1)
    ref = [a.clone().requires_grad_() for a in args[:5]]
    o, _ = W.wkv6_plain(*ref, args[5])
    (o * o).sum().backward()
    for g, r in zip(ins, ref):
        assert rel_err(g.grad, r.grad) <= GRAD_TOL
    with pytest.raises(ValueError, match="initial state"):
        W.wkv6(*ins, args[5].clone().requires_grad_())


# (B, Sq, Sk, H, KV, hd): GQA and MHA, causal training shapes, ragged
# tiles, Sq < Sk
FLASH_BWD_SHAPES = ((2, 64, 64, 4, 1, 16), (2, 100, 100, 4, 2, 32),
                    (1, 70, 130, 4, 4, 64), (1, 128, 128, 8, 2, 128),
                    (2, 1, 9, 2, 2, 64))
# bf16 gradients: within BF16_GRAD_TOL of each one's largest magnitude from
# f64 (tests/test_kernels.py's bf16 tolerance), and no farther from it
# than WITNESS times autograd's backward of SDPA in bf16 on the same inputs
BF16_GRAD_TOL = 2e-2
WITNESS = 2


def sdpa_grads(q, k, v, do, causal):
    """Autograd's backward of torch's scaled_dot_product_attention
    (enable_gqa; the causal mask right-aligned, as the kernels') on the
    port's layout, in the inputs' dtype: the library's own rounding, the
    bf16 witness."""
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = None
    if causal and sq != sk:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    return [g.transpose(1, 2) for g in torch.autograd.grad(
        o, (qt, kt, vt), do.transpose(1, 2))]


def assert_bf16_grads(got, truth, lib):
    """bf16 gradients, finite, within BF16_GRAD_TOL of f64's and within
    WITNESS times SDPA's worst distance from it."""
    for g in got:
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
    ours = max(rel_err(g, t) for g, t in zip(got, truth))
    theirs = max(rel_err(g, t) for g, t in zip(lib, truth))
    assert ours <= BF16_GRAD_TOL, ours
    assert ours <= WITNESS * theirs, (ours, theirs)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_plain(cuda, dtype, shape, causal):
    """The backward kernels (from the forward's log-sum-exp) against
    attention_backward_plain in f64 and, in f32, autograd of
    attention_plain; in bf16 against the witness (assert_bf16_grads)."""
    q, k, v = flash_inputs(sum(shape) + 1, *shape, dtype, cuda)
    do = flash_inputs(sum(shape) + 2, *shape, dtype, cuda)[0]
    o, lse = FA._flash_kernel(q, k, v, causal, with_lse=True)
    scores, _ = _scores(q, k, causal)
    torch.testing.assert_close(
        lse, torch.logsumexp(scores, dim=-1).reshape(lse.shape), rtol=1e-5,
        atol=1e-5)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert FA.flash_attention_bwd.launches == before + 1
    truth = FA.attention_backward_plain(q.double(), k.double(), v.double(),
                                        do.double(), causal=causal)
    if dtype == torch.bfloat16:
        lib = sdpa_grads(q, k, v, do, causal)
        torch.cuda.synchronize()
        assert_bf16_grads(got, truth, lib)
        return
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(attention_plain(*ins, causal=causal), ins, do)
    torch.cuda.synchronize()
    for g, t, a in zip(got, truth, auto):
        assert torch.isfinite(g).all()
        assert rel_err(g, t) <= GRAD_TOL
        assert rel_err(g, a) <= GRAD_TOL


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_ragged_key_block_on_the_diagonal(cuda, dtype, hd):
    """Sq = Sk = 100, causal: flash_bwd_dkdv's second key block (keys 64-99,
    ragged at 100) holds the diagonal, so its query tiles see it partly
    masked and its last 28 keys are padding; GQA 4 over 2."""
    shape = (1, 100, 100, 4, 2, hd)
    q, k, v = flash_inputs(hd + 5, *shape, dtype, cuda)
    do = flash_inputs(hd + 6, *shape, dtype, cuda)[0]
    o, lse = FA._flash_kernel(q, k, v, True, with_lse=True)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do)
    truth = FA.attention_backward_plain(q.double(), k.double(), v.double(),
                                        do.double())
    tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    if dtype == torch.bfloat16:
        assert_bf16_grads(got, truth, sdpa_grads(q, k, v, do, True))
    torch.cuda.synchronize()
    for g, t in zip(got, truth):
        assert rel_err(g, t) <= tol
    # the ragged block's own rows of dk and dv
    for g, t in zip(got[1:], truth[1:]):
        assert rel_err(g[:, 64:], t[:, 64:]) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_repeat_bit_for_bit(cuda, dtype):
    """Two calls of each backward kernel on the same inputs give the same
    bits: no atomics, every sum in a fixed order (the trainer's restarts
    rely on it).  wkv6_bwd takes f32 only: the bf16 case holds the
    attention backward's bf16 form."""
    if dtype == torch.float32:
        args = wkv_inputs(np.random.default_rng(11), 2, 100, 3, 64, cuda,
                          False, "random")
        gen = torch.Generator(device=cuda).manual_seed(11)
        do = torch.randn((2, 100, 3, 64), generator=gen, device=cuda)
        ds = torch.randn((2, 3, 64, 64), generator=gen, device=cuda)
        first, again = (W.wkv6_bwd(*args, do, ds) for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    shape = (2, 130, 130, 8, 2, 128)
    q, k, v = flash_inputs(13, *shape, dtype, cuda)
    do = flash_inputs(14, *shape, dtype, cuda)[0]
    o, lse = FA._flash_kernel(q, k, v, True, with_lse=True)
    first, again = (FA.flash_attention_bwd(q, k, v, o, lse, do)
                    for _ in range(2))
    assert all(x.dtype == dtype for x in first)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_flash_autograd_on_card(cuda):
    """flash_attention with inputs that require grad goes through
    FlashAttentionFunction (one forward and one backward call), in f32
    and in bf16, whose gradients come back bf16 and are held against f64
    and the witness (assert_bf16_grads)."""
    q, k, v = flash_inputs(9, 2, 64, 64, 4, 2, 64, torch.float32, cuda)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    f0, b0 = FA.flash_attention.launches, FA.flash_attention_bwd.launches
    o = FA.flash_attention(*ins)
    (o * o).sum().backward()
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    (attention_plain(*ref) ** 2).sum().backward()
    for g, r in zip(ins, ref):
        assert rel_err(g.grad, r.grad) <= GRAD_TOL
    bf = [x.bfloat16().requires_grad_() for x in (q, k, v)]
    do = flash_inputs(10, 2, 64, 64, 4, 2, 64, torch.bfloat16, cuda)[0]
    f0, b0 = FA.flash_attention.launches, FA.flash_attention_bwd.launches
    o = FA.flash_attention(*bf)
    assert o.dtype == torch.bfloat16
    o.backward(do)
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    x64 = [x.detach().double() for x in bf]
    truth = FA.attention_backward_plain(*x64, do.double())
    lib = sdpa_grads(*(x.detach() for x in bf), do, True)
    torch.cuda.synchronize()
    assert_bf16_grads([x.grad for x in bf], truth, lib)


@pytest.mark.parametrize("causal", [True, False])
def test_seqpar_attention_on_card(cuda, causal):
    """seqpar_attention over 4 slabs of 128 queries on the card: K3' once
    per slab, causal over the keys up to the slab's end (Sq < Sk), and
    its backward once per slab; against attention_plain on the whole
    sequence, the output within 2e-5 and the gradients within
    GRAD_TOL."""
    from repro_torch.models.layers.attention import seqpar_attention
    dev = torch.device("cuda", 0)
    q, k, v = flash_inputs(21, 2, 512, 512, 6, 2, 64, torch.float32, dev)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    f0, b0 = FA.flash_attention.launches, FA.flash_attention_bwd.launches
    o = seqpar_attention(*ins, causal=causal, devices=[dev] * 4)
    (o * o).sum().backward()
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == (f0 + 4, b0 + 4)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    whole = attention_plain(*ref, causal=causal)
    assert float((o - whole).abs().max()) <= 2e-5
    (whole ** 2).sum().backward()
    for g, r in zip(ins, ref):
        assert rel_err(g.grad, r.grad) <= GRAD_TOL


# ---------------------------------------------------------------------------
# training on the card: reduced models through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minitron-8b"])
def test_train_on_card(cuda, arch, tmp_path, monkeypatch):
    """Reduced models train through the kernels: per step the forward
    kernel twice per layer (forward and the checkpoint's recompute) and
    the backward once; gradients within 1e-4 of the plain versions'
    (leaf by leaf, of its largest magnitude); 2 steps, a save, 2 steps
    equal 2, restore, 2 bit for bit."""
    from repro_torch.checkpointing.checkpoint import restore, save
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.models.layers import attention as attn_layers
    from repro_torch.models.layers import rwkv6 as rwkv_layers
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_reduced(arch)
    rwkv = cfg.family == "ssm"
    fwd, bwd = (W.wkv6, W.wkv6_bwd) if rwkv else (FA.flash_attention,
                                                  FA.flash_attention_bwd)
    tree = seeded_lm_params(cfg, 0)
    opt_cfg = OptConfig(peak_lr=1e-2, warmup_steps=1, total_steps=8)
    state = TS.init_train_state(
        LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, cuda)), cfg,
        opt_cfg)
    shape = ShapeSpec("t", 64, 2, "train")

    def batch(step):
        return to_device(make_batch_np(cfg, shape, 3, step), cuda)

    _, _, g_k = TS._grads(state["params"], batch(100), cfg)
    if rwkv:
        monkeypatch.setattr(rwkv_layers, "wkv6", W.wkv6_plain)
    else:
        monkeypatch.setattr(attn_layers, "flash_attention", attention_plain)
    _, _, g_p = TS._grads(state["params"], batch(100), cfg)
    monkeypatch.undo()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    for name in g_k:
        assert rel_err(g_k[name], g_p[name]) <= GRAD_TOL, name
    step_fn = TS.make_train_step(cfg, opt_cfg)

    def run(start, n):
        for step in range(start, start + n):
            f0, b0 = fwd.launches, bwd.launches
            _, m = step_fn(state, batch(step))
            assert (fwd.launches - f0, bwd.launches - b0) == (
                2 * cfg.n_layers, cfg.n_layers)
            assert torch.isfinite(m["loss"]) and torch.isfinite(
                m["grad_norm"])

    run(0, 2)
    save(str(tmp_path), 2, state, cfg)
    run(2, 2)
    want = [t.clone() for t in state["params"].state_dict().values()]
    restore(str(tmp_path), 2, state, cfg)
    run(2, 2)
    for a, b in zip(state["params"].state_dict().values(), want):
        assert torch.equal(a, b)


def test_lm_kernels_launch_on_their_tensors_device(cuda):
    """wkv6 and flash_attention, forward and backward, on tensors of a
    second card while the first is current: each launches on its tensors'
    card and equals its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card: launches on cuda:1 while "
                    "cuda:0 is current")
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        args = wkv_inputs(np.random.default_rng(12), 2, 64, 2, 64, other,
                          True)
        ins = [a.clone().requires_grad_() for a in args[:5]]
        o, _ = W.wkv6(*ins, args[5])
        (o * o).sum().backward()
        ref = [a.clone().requires_grad_() for a in args[:5]]
        o_ref, _ = W.wkv6_plain(*ref, args[5])
        (o_ref * o_ref).sum().backward()
        assert o.device == other
        for g, r in zip(ins, ref):
            assert g.grad.device == other
            assert rel_err(g.grad, r.grad) <= GRAD_TOL
        q, k, v = (x.requires_grad_() for x in flash_inputs(
            13, 2, 64, 64, 4, 2, 128, torch.float32, other))
        out = FA.flash_attention(q, k, v)
        (out * out).sum().backward()
        ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        (attention_plain(*ref) ** 2).sum().backward()
        for g, r in zip((q, k, v), ref):
            assert g.grad.device == other
            assert rel_err(g.grad, r.grad) <= GRAD_TOL
