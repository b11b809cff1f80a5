"""The warp-issue kernel's plain version (``issue_select_plain``), which
the wrapper runs on CPU tensors, against the JAX package.

  · On the TPU kernel's contract (no barrier wait, GTO, instr_base 0,
    n_instr = len(ops)) ``sel_open`` equals ``issue_select_ref`` and the
    Pallas kernel ``issue_select_pallas`` (interpret mode), exact.
  · On the full selection contract (barriers, LRR, a ragged instr_base,
    n_instr < len(ops)) ``sel_open`` and ``sel_closed`` are the warps the
    reference's ``_issue_subcore`` picks with every MSHR row free and with
    none free.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.config as JC
import repro.sim.smcore as JSM
import repro.sim.state as JS
from repro.kernels.sm_issue.kernel import issue_select_pallas
from repro.kernels.sm_issue.ref import issue_select_ref
from repro_torch.kernels.sm_issue import kernel as K


def k1_inputs(seed):
    """tests/test_kernels.py:test_sm_issue_property's generator."""
    rng = np.random.default_rng(seed)
    n_sm, w, sc, L = 4, 8, 2, 16
    args = (rng.integers(0, L + 2, (n_sm, w)).astype(np.int32),
            rng.random((n_sm, w)) < 0.7,
            rng.integers(0, 20, (n_sm, w)).astype(np.int32),
            rng.integers(0, 2, (n_sm, w)).astype(np.int32),
            rng.random((n_sm, w)) < 0.3,
            rng.integers(-1, w, (n_sm, sc)).astype(np.int32),
            rng.integers(0, 15, (n_sm, sc, JC.N_UNITS)).astype(np.int32),
            rng.integers(0, 6, (L,)).astype(np.int32),
            rng.random((L,)) < 0.5,
            int(rng.integers(0, 15)))
    return args, sc


def plain_k1(args, sc):
    pc, active, ready_at, pending, wait_mem, last, ufree, ops, _, t = args
    T = torch.as_tensor
    return K.issue_select(
        T(pc), T(active), T(ready_at), T(pending), T(wait_mem),
        torch.zeros(pc.shape, dtype=torch.bool), T(last), T(ufree), T(ops),
        len(ops), 0, JC.SCHED_GTO, t, n_subcores=sc)


@pytest.mark.parametrize("seed", range(8))
def test_k1_contract_matches_ref_and_pallas(seed):
    args, sc = k1_inputs(seed)
    jargs = tuple(jnp.asarray(a) for a in args[:-1]) + (args[-1],)
    ref = np.asarray(issue_select_ref(*jargs, n_subcores=sc))
    pallas = np.asarray(issue_select_pallas(*jargs, n_subcores=sc))
    sel_open, sel_closed = plain_k1(args, sc)
    assert np.array_equal(sel_open.numpy(), ref)
    assert np.array_equal(sel_open.numpy(), pallas)
    # sel_closed: the reference's pick once warps at an LDG/STG sit out
    pc, active, ops = args[0], args[1], args[7]
    op = ops[np.clip(pc, 0, len(ops) - 1)]
    no_mem = active & (op != JC.LDG) & (op != JC.STG)
    ref_closed = issue_select_ref(jargs[0], jnp.asarray(no_mem),
                                  *jargs[2:], n_subcores=sc)
    assert np.array_equal(sel_closed.numpy(), np.asarray(ref_closed))


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    args, sc = k1_inputs(0)
    before = K.issue_select.launches
    got = plain_k1(args, sc)
    T = torch.as_tensor
    pc, active, ready_at, pending, wait_mem, last, ufree, ops, _, t = args
    want = K.issue_select_plain(
        T(pc), T(active), T(ready_at), T(pending), T(wait_mem),
        torch.zeros(pc.shape, dtype=torch.bool), T(last), T(ufree), T(ops),
        len(ops), 0, JC.SCHED_GTO, t, n_subcores=sc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.issue_select.launches == before


# ---------------------------------------------------------------------------
# the full selection contract against the reference's _issue_subcore
# ---------------------------------------------------------------------------

SC4 = dataclasses.replace(JC.TINY, n_sm=4, warps_per_sm=16, n_subcores=4)


def full_case(rng, cfg, ragged):
    """A JAX-side (warp, sm, trace, t) with barrier waits and a padded
    instruction stream (n_instr <= len(ops)); when ``ragged``, the
    kernel's instructions start at instr_base > 0."""
    scfg = JC.static_part(cfg)
    ns, w, sc = scfg.n_sm, scfg.warps_per_sm, scfg.n_subcores
    base = jax.tree_util.tree_map(np.asarray, JS.init_state(scfg))
    n_ops = 24          # one shape per config: the reference compiles once
    pre = int(rng.integers(1, 6)) if ragged else 0
    L = int(rng.integers(1, n_ops - pre + 1))
    t = 200
    warp = dict(base["warp"],
                pc=rng.integers(0, L + 2, (ns, w)).astype(np.int32),
                active=rng.random((ns, w)) < 0.8,
                ready_at=rng.integers(t - 10, t + 6, (ns, w)).astype(
                    np.int32),
                pending=rng.integers(0, 3, (ns, w)).astype(np.int32),
                wait_mem=rng.random((ns, w)) < 0.3,
                wait_bar=rng.random((ns, w)) < 0.25,
                cta=rng.integers(0, 4, (ns, w)).astype(np.int32),
                wic=rng.integers(0, 4, (ns, w)).astype(np.int32))
    sm = dict(base["sm"],
              last_issued=rng.integers(-1, w, (ns, sc)).astype(np.int32),
              unit_free=rng.integers(t - 4, t + 4, (ns, sc, JC.N_UNITS)
                                     ).astype(np.int32))
    trace = {"ops": rng.integers(0, JC.N_CLASSES, n_ops).astype(np.int32),
             "dep": rng.random(n_ops) < 0.5,
             "addr_mode": rng.integers(0, 4, n_ops).astype(np.int32),
             "addr_param": rng.integers(0, 64, n_ops).astype(np.int32),
             "n_ctas": np.int32(8), "warps_per_cta": np.int32(4),
             "n_instr": np.int32(L)}
    if ragged:
        trace["instr_base"] = np.int32(pre)
    return warp, sm, base, trace, t


@partial(jax.jit, static_argnums=(4,))
def _reference_picks(warp, sm, req, trace, cfg, dyn, t):
    """The warp slot the reference's _issue_subcore issues on each
    sub-core of every SM, or -1: (n_sm, SC), each sub-core from the same
    state."""
    def one(w, s, r, sc):
        st = {"issued": 0, "issued_mem": 0, "l1_hit": 0, "l1_miss": 0,
              "stall": 0}
        _, s2, _, _, do = JSM._issue_subcore(w, s, r, st, trace, t, sc,
                                             cfg, dyn)
        return jnp.where(do, s2["last_issued"][sc], -1)
    return jnp.stack([jax.vmap(lambda w, s, r: one(w, s, r, sc))(
        warp, sm, req) for sc in range(cfg.n_subcores)], axis=1)


@pytest.mark.parametrize("cfg", ["TINY", "SC4"])
@pytest.mark.parametrize("sched", ["gto", "lrr"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_full_contract_matches_issue_subcore(cfg, sched, ragged, seed):
    jcfg = SC4 if cfg == "SC4" else JC.TINY
    scfg, dyn = JC.split_config(jcfg, {"sched": JC.SCHEDULERS[sched]})
    rng = np.random.default_rng(1000 * seed + 7 * ragged + len(sched))
    warp, sm, base, trace, t = full_case(rng, jcfg, ragged)
    ns, m = scfg.n_sm, scfg.mshr_per_sm
    jtree = partial(jax.tree_util.tree_map, jnp.asarray)
    want = {}
    for label, stage in (("open", 0), ("closed", 1)):
        req = dict(base["req"], stage=np.full((ns, m), stage, np.int32))
        want[label] = np.asarray(_reference_picks(
            jtree(warp), jtree(sm), jtree(req), jtree(trace), scfg, dyn,
            jnp.int32(t)))
    T = torch.as_tensor
    sel_open, sel_closed = K.issue_select(
        T(warp["pc"]), T(warp["active"]), T(warp["ready_at"]),
        T(warp["pending"]), T(warp["wait_mem"]), T(warp["wait_bar"]),
        T(sm["last_issued"]), T(sm["unit_free"]), T(trace["ops"]),
        int(trace["n_instr"]), int(trace.get("instr_base", 0)),
        JC.SCHEDULERS[sched], t, n_subcores=scfg.n_subcores)
    assert np.array_equal(sel_open.numpy(), want["open"])
    assert np.array_equal(sel_closed.numpy(), want["closed"])
