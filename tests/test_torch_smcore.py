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
import repro_torch.sim.trace as PT
from repro_torch.convert import dyn_to_torch, to_numpy, to_torch

T0 = 320
SC4 = dict(n_sm=4, warps_per_sm=16, n_subcores=4, mshr_per_sm=6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_quantum_inputs(rng, scfg, ragged=False):
    """(warp, sm, req, stats_sm, trace) as numpy, every leaf randomized."""
    ns, w, sc = scfg.n_sm, scfg.warps_per_sm, scfg.n_subcores
    m, wpc = scfg.mshr_per_sm, 4
    n_ops = 40
    pre = int(rng.integers(1, 8)) if ragged else 0
    L = int(rng.integers(8, n_ops - pre + 1))
    ops = rng.choice(np.arange(JC.N_CLASSES), n_ops,
                     p=[.25, .15, .05, .1, .2, .15, .1]).astype(np.int32)
    trace = {"ops": ops, "dep": rng.random(n_ops) < 0.5,
             "addr_mode": rng.integers(1, 4, n_ops).astype(np.int32),
             "addr_param": rng.integers(0, 4, n_ops).astype(np.int32),
             "n_ctas": np.int32(40), "warps_per_cta": np.int32(wpc),
             "n_instr": np.int32(L)}
    if ragged:
        trace["instr_base"] = np.int32(pre)
    cta = (np.arange(w) // wpc + rng.integers(0, 6, (ns, 1))).astype(
        np.int32)
    warp = {
        "pc": rng.integers(0, L + 1, (ns, w)).astype(np.int32),
        "active": rng.random((ns, w)) < 0.85,
        "ready_at": rng.integers(T0 - 8, T0 + 12, (ns, w)).astype(np.int32),
        "pending": rng.integers(0, 3, (ns, w)).astype(np.int32),
        "wait_mem": rng.random((ns, w)) < 0.3,
        "wait_bar": rng.random((ns, w)) < 0.2,
        "cta": cta,
        "wic": (np.arange(w) % wpc + np.zeros((ns, 1), int)).astype(
            np.int32),
    }
    # on half the SMs, every warp of the first CTA waits at the barrier
    warp["wait_bar"][::2, :wpc] = True
    # warm L1: the addresses the warps are about to touch, in random ways
    gwarp = warp["cta"] * wpc + warp["wic"]
    pcs = np.clip(warp["pc"] + rng.integers(0, 3, (ns, w)), 0, L - 1)
    addr = PT.gen_address(*(torch.as_tensor(x) for x in (
        trace["addr_mode"][pre + pcs], trace["addr_param"][pre + pcs],
        gwarp, pcs)),
        scfg.mem_blocks).numpy()
    l1_tag = rng.integers(0, 1 << 20, (ns, scfg.l1_sets, scfg.l1_ways)
                          ).astype(np.int32)
    for s in range(ns):
        for a in addr[s][rng.random(w) < 0.5]:
            l1_tag[s, a % scfg.l1_sets, rng.integers(scfg.l1_ways)] = a
    cap = scfg.addrset_cap
    addrset = np.where(rng.random((ns, cap)) < rng.random(),
                       rng.integers(0, 1 << 20, (ns, cap)), -1
                       ).astype(np.int32)
    sm = {
        "last_issued": rng.integers(-1, w, (ns, sc)).astype(np.int32),
        "unit_free": rng.integers(T0 - 4, T0 + 6, (ns, sc, JC.N_UNITS)
                                  ).astype(np.int32),
        "l1_tag": l1_tag,
        "l1_lru": rng.integers(0, T0, l1_tag.shape).astype(np.int32),
        "addrset": addrset,
        "addrset_over": rng.integers(0, 3, ns).astype(np.int32),
    }
    # busy MSHRs: per SM 0..2 free rows at the start
    stage = rng.integers(1, 4, (ns, m)).astype(np.int32)
    for s in range(ns):
        stage[s, rng.permutation(m)[:rng.integers(0, 3)]] = 0
    req = {
        "stage": stage,
        "addr": rng.integers(0, 1 << 20, (ns, m)).astype(np.int32),
        "t": rng.integers(T0 - 4, T0 + 24, (ns, m)).astype(np.int32),
        "warp": rng.integers(0, w, (ns, m)).astype(np.int32),
        "is_store": rng.random((ns, m)) < 0.3,
    }
    stats_sm = {k: rng.integers(0, 50, ns).astype(np.int32) for k in (
        "issued", "issued_mem", "l1_hit", "l1_miss", "cycles_issue",
        "stall", "warp_cycles")}
    return warp, sm, req, stats_sm, trace


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
    got = PP.make_sm_runner(pcfg, mode)(
        *(to_torch(x, "cpu") for x in inputs),
        torch.tensor(T0, dtype=torch.int32), pdyn)
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
