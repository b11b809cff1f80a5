"""SM-axis sharding (``mode='shard'``, core/parallel.py) on a mesh that
puts the CPU at every position: the port's counterpart of
tests/test_sim_shard.py and of the shard arm of
tests/test_determinism_matrix.py.

  · ``run_workload`` with ``run_kernel_sharded`` as its kernel runner, on
    2 and 4 shards, ``static`` and ``dynamic`` SM assignment, ``window``
    and ``cycle`` exchange, over the four cases of
    tests/golden/determinism_tiny.json (the JAX package's numbers), each
    held against the golden and, on the cheapest case, against the port's
    vmap run (tests/test_torch_engine.py holds the vmap runs of the other
    cases to the same golden); ``timeouts`` included (hotspot@0.02, whose
    cycle cap cuts 2 of its 4 kernels, runs in
    tests/test_torch_shard_timeouts.py);
  · ``sm_permutation`` and ``permute_state`` against the reference's;
  · the SM phase runner of ``make_sm_runner(cfg, 'shard', mesh)`` against
    the vmap runner on seeded lanes;
  · splitting a lane-batched state into SM blocks: every block its own
    contiguous tensor, and gathered back equal to the whole.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.parallel as JP
import repro.sim.config as JC
import repro.sim.state as JSTATE
from repro_torch.convert import random_lane_inputs, to_numpy, to_torch
from repro_torch.core import stats as S
from repro_torch.core.engine import run_workload, simulate
from repro_torch.core.parallel import (gather_sm, make_sm_runner,
                                       permute_state, run_kernel_sharded,
                                       sm_permutation, split_sm)
from repro_torch.core.stats import take_lane
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sim.config import TINY, DynConfig, split_config, static_part
from repro_torch.sim.state import init_state
from repro_torch.sim.workloads import resolve_workload

MAX_CYCLES = 1 << 15          # as tests/test_determinism_matrix.py
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "determinism_tiny.json")
CPU = torch.device("cpu")
# (workload, scale, shards, policy, exchange, timeouts, against vmap):
# with tests/test_torch_shard_timeouts.py's hotspot@0.02 (2 shards,
# static, window), every golden case, 2 and 4 shards, both policies and
# both exchanges
CASES = [
    ("trace:gather_chain", 1.0, 4, "dynamic", "cycle", 0, True),
    ("trace:gather_chain", 1.0, 4, "static", "window", 0, True),
    ("myocyte", 1.0, 2, "dynamic", "window", 0, False),
    ("zoo:mixed", 0.03, 2, "dynamic", "window", 0, False),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def vmap_runs():
    """The port's vmap runs, one per workload, made on first use."""
    cache = {}

    def get(bench, scale):
        if (bench, scale) not in cache:
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                cache[bench, scale] = S.finalize(simulate(
                    resolve_workload(bench, scale), TINY,
                    make_sm_runner(TINY, "vmap"), max_cycles=MAX_CYCLES,
                    device="cpu"))
            finally:
                torch.set_num_threads(n)
        return cache[bench, scale]
    return get


def run_shard(workload, n_dev, policy="static", exchange="window"):
    """tests/test_determinism_matrix.py's ``run_shard``, on the port."""
    scfg, dyn = split_config(TINY, device=CPU)
    mesh = make_host_mesh(n_dev, "sm", device="cpu")
    state = permute_state(init_state(scfg, CPU, 1),
                          sm_permutation(TINY, n_dev, policy))
    state = run_workload(
        state, [k.pack(CPU) for k in workload.kernels], scfg, dyn,
        kernel_runner=lambda st, packed, d: run_kernel_sharded(
            st, packed, TINY, mesh, max_cycles=MAX_CYCLES,
            exchange=exchange, dyn=d))
    return S.finalize(take_lane(state, 0))


@pytest.mark.parametrize(
    "bench,scale,n_dev,policy,exchange,timeouts,vs_vmap", CASES,
    ids=[f"{b}@{s}-{n}-{p}-{e}" for b, s, n, p, e, _, _ in CASES])
def test_shard_equals_golden_and_vmap(golden, vmap_runs, bench, scale, n_dev,
                                      policy, exchange, timeouts, vs_vmap):
    got = run_shard(resolve_workload(bench, scale), n_dev, policy, exchange)
    assert S.comparable(got) == golden[f"{bench}@{scale}"]
    assert got["timeouts"] == timeouts
    if vs_vmap:
        ref = vmap_runs(bench, scale)
        assert dict(S.comparable(got), timeouts=got["timeouts"]) == \
            dict(S.comparable(ref), timeouts=ref["timeouts"])


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("policy", ["static", "dynamic"])
def test_sm_permutation_equal(n_dev, policy):
    for cfg, jcfg in ((TINY, JC.TINY),
                      (static_part(TINY), JC.static_part(JC.TINY))):
        assert np.array_equal(sm_permutation(cfg, n_dev, policy),
                              JP.sm_permutation(jcfg, n_dev, policy))
    with pytest.raises(ValueError):
        sm_permutation(TINY, n_dev, "guided")


def test_permute_state_equal():
    """The port's permutation of a seeded lane-batched state equals the
    reference's, lane by lane; sm_ids keeps the original ids and every
    permuted leaf is a contiguous tensor of its own."""
    rng = np.random.default_rng(19)
    scfg = static_part(TINY)
    (warp, sm, req, stats_sm, _), _, _ = random_lane_inputs(rng, scfg, 2)
    perm = rng.permutation(scfg.n_sm)
    host = {"warp": warp, "sm": sm, "req": req, "stats_sm": stats_sm}
    state = dict(init_state(scfg, CPU, 2), **to_torch(host, CPU))
    got = permute_state(state, perm)
    assert got["ctrl"]["sm_ids"].tolist() == [perm.tolist()] * 2
    for part in ("warp", "sm", "req", "stats_sm"):
        for v in got[part].values():
            assert v.is_contiguous()
    jstate = JSTATE.init_state(JC.static_part(JC.TINY))
    for lane in range(2):
        jlane = dict(jstate, **{k: {f: jnp.asarray(v[lane])
                                    for f, v in host[k].items()}
                                for k in host})
        want = JP.permute_state(jlane, perm)
        for part in ("warp", "sm", "req", "stats_sm", "ctrl"):
            for f, v in want[part].items():
                assert np.array_equal(
                    to_numpy(got[part][f])[lane], np.asarray(v)), (part, f)


def test_permuted_vmap_equals_golden(golden):
    """A permuted state on one device: the relabelling alone leaves every
    comparable stat as the golden has it."""
    scfg, dyn = split_config(TINY, device=CPU)
    w = resolve_workload("trace:gather_chain", 1.0)
    state = run_workload(
        permute_state(init_state(scfg, CPU, 1),
                      sm_permutation(TINY, 4, "dynamic")),
        [k.pack(CPU) for k in w.kernels], scfg, dyn,
        make_sm_runner(TINY, "vmap"), MAX_CYCLES)
    assert S.comparable(S.finalize(take_lane(state, 0))) == \
        golden["trace:gather_chain@1.0"]


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shard_sm_runner_equals_vmap(n_dev):
    """One quantum of three seeded lanes: the shard runner (blocks split,
    each block's SM phase, gathered back) equals the vmap runner."""
    rng = np.random.default_rng(n_dev)
    scfg = static_part(TINY)
    host, t0s, over = random_lane_inputs(rng, scfg, 3)
    dyn = DynConfig.stack([split_config(TINY, o, device=CPU)[1]
                           for o in over])
    args = [to_torch(x, CPU) for x in host]
    t0 = torch.tensor(t0s)
    want = make_sm_runner(TINY, "vmap")(*args, t0, dyn)
    mesh = make_host_mesh(n_dev, device="cpu")
    got = make_sm_runner(TINY, "shard", mesh)(*args, t0, dyn)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]), k


def test_split_sm_blocks_are_contiguous_and_gather_back():
    """A slice of several lanes along the SM axis is not contiguous, and
    sm_quantum takes no other: every block is a tensor of its own."""
    state = init_state(static_part(TINY), CPU, 3)
    warp = dict(state["warp"], pc=torch.arange(3 * 8 * 8, dtype=torch.int32
                                               ).reshape(3, 8, 8))
    assert not warp["pc"][:, 2:4].is_contiguous()
    blocks = split_sm(warp, [CPU] * 4)
    assert [b["pc"].shape for b in blocks] == [(3, 2, 8)] * 4
    assert all(v.is_contiguous() for b in blocks for v in b.values())
    back = gather_sm(blocks, CPU)
    assert all(torch.equal(back[k], warp[k]) for k in warp)
