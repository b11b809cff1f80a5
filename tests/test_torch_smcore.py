"""The SM phase: one whole-state quantum of the port against the JAX
package's, exact, on seeded random states, in seq and vmap modes, under
GTO and LRR, with CTA barriers, warm L1s and address sets, and MSHR tables
with fewer free rows than sub-cores."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.parallel as JP
import repro.sim.config as JC
import repro_torch.core.parallel as PP
import repro_torch.sim.config as PC
from repro_torch.convert import QUANTUM_T0 as T0
from repro_torch.convert import (dyn_to_torch, random_quantum_inputs,
                                 stack_lanes, to_numpy, to_torch)

SC4 = dict(n_sm=4, warps_per_sm=16, n_subcores=4, mshr_per_sm=6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@partial(jax.jit, static_argnums=(5, 6))
def _reference_quantum(warp, sm, req, stats_sm, trace, cfg, mode, dyn, t0):
    return JP.make_sm_runner(cfg, mode)(warp, sm, req, stats_sm, trace, t0,
                                        dyn)


def run_both(inputs, jcfg, pcfg, mode, sched):
    jscfg, jdyn = JC.split_config(jcfg, {"sched": JC.SCHEDULERS[sched]})
    pdyn = dyn_to_torch({k: np.asarray(v) for k, v in jdyn.flat().items()},
                        "cpu")
    want = _reference_quantum(
        *jax.tree_util.tree_map(jnp.asarray, inputs), jscfg, mode, jdyn,
        jnp.int32(T0))
    # the port's one-lane case: a leading lane axis of length 1
    got = PP.make_sm_runner(pcfg, mode)(
        *(to_torch(stack_lanes([x]), "cpu") for x in inputs),
        torch.tensor([T0], dtype=torch.int32), pdyn.map(lambda x: x[None]))
    got = [{k: v[0] for k, v in g.items()} for g in got]
    names = ("warp", "sm", "req", "stats_sm")
    for name, w, g in zip(names, want, got):
        w = jax.tree_util.tree_map(np.asarray, w)
        g = to_numpy(g)
        assert w.keys() == g.keys(), name
        for k in w:
            assert w[k].dtype == g[k].dtype, (name, k)
            assert np.array_equal(w[k], g[k]), (name, k)
    return want


@pytest.mark.parametrize("mode", ["seq", "vmap"])
@pytest.mark.parametrize("sched", ["gto", "lrr"])
@pytest.mark.parametrize("seed", range(3))
def test_quantum_equal_tiny(mode, sched, seed):
    rng = np.random.default_rng(seed)
    inputs = random_quantum_inputs(rng, JC.static_part(JC.TINY))
    want = run_both(inputs, JC.TINY, PC.TINY, mode, sched)
    # the seeded states do exercise issue, L1 hits and misses, barriers
    for k in ("issued", "l1_hit", "l1_miss"):
        assert (np.asarray(want[3][k]) > inputs[3][k]).any(), k
    assert (~np.asarray(want[0]["wait_bar"]) & inputs[0]["wait_bar"]).any()


@pytest.mark.parametrize("sched", ["gto", "lrr"])
def test_quantum_equal_ragged(sched):
    rng = np.random.default_rng(11)
    inputs = random_quantum_inputs(rng, JC.static_part(JC.TINY), ragged=True)
    run_both(inputs, JC.TINY, PC.TINY, "vmap", sched)


@pytest.mark.parametrize("mode", ["seq", "vmap"])
def test_quantum_equal_four_subcores(mode):
    """Four sub-cores share a 6-row MSHR table: the free-row gate binds
    within a cycle."""
    rng = np.random.default_rng(5)
    jcfg = dataclasses.replace(JC.TINY, **SC4)
    pcfg = dataclasses.replace(PC.TINY, **SC4)
    inputs = random_quantum_inputs(rng, JC.static_part(jcfg))
    run_both(inputs, jcfg, pcfg, mode, "gto")


def test_idle_sms_pass_through():
    """No active warp, no request, no warp at a barrier: the quantum
    changes nothing."""
    rng = np.random.default_rng(2)
    warp, sm, req, stats_sm, trace = random_quantum_inputs(
        rng, JC.static_part(JC.TINY))
    warp = dict(warp, active=np.zeros_like(warp["active"]),
                wait_bar=np.zeros_like(warp["wait_bar"]))
    req = dict(req, stage=np.zeros_like(req["stage"]))
    want = run_both((warp, sm, req, stats_sm, trace), JC.TINY, PC.TINY,
                    "vmap", "gto")
    assert np.array_equal(np.asarray(want[0]["pc"]), warp["pc"])
