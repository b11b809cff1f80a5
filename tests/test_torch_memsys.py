"""The memory phase: the port's ``mem_phase`` (and its sort and scan
helpers) against the JAX package's on seeded request tables, exact.

Covers the reference's duplicate-index scatter into ``dram_row`` (the last
channel keeps the value of the last row in sorted order that targets it)
and ties in the (resource, time, row) order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.config as JC
import repro.sim.memsys as JM
import repro.sim.state as JS
import repro_torch.sim.config as PC
import repro_torch.sim.memsys as PM
from repro_torch.convert import dyn_to_torch, to_numpy, to_torch

JSCFG, JDYN = JC.split_config(JC.TINY)
PSCFG = PC.static_part(PC.TINY)
# the reference's memory phase, compiled once per shape (cfg is static)
J_MEM_PHASE = jax.jit(JM.mem_phase, static_argnums=(4,))
PDYN = dyn_to_torch({k: np.asarray(v) for k, v in JDYN.flat().items()},
                    "cpu")


def random_mem_inputs(rng, t0, scfg=JSCFG, addr_hi=4096, random_mem=False):
    """As tests/test_memsys_invariants.py:random_mem_inputs, optionally
    with a warm, random L2/DRAM state."""
    ns, m = scfg.n_sm, scfg.mshr_per_sm
    state = jax.tree_util.tree_map(np.asarray, JS.init_state(scfg))
    req = {
        "stage": rng.integers(0, 4, (ns, m)).astype(np.int32),
        "addr": rng.integers(0, addr_hi, (ns, m)).astype(np.int32),
        "t": rng.integers(0, t0 + 2 * scfg.quantum, (ns, m)).astype(
            np.int32),
        "warp": np.zeros((ns, m), np.int32),
        "is_store": rng.integers(0, 2, (ns, m)) == 1,
    }
    mem = dict(state["mem"])
    if random_mem:
        mem["l2_tag"] = rng.integers(-1, addr_hi, mem["l2_tag"].shape
                                     ).astype(np.int32)
        mem["l2_lru"] = rng.integers(0, max(t0, 1), mem["l2_lru"].shape
                                     ).astype(np.int32)
        mem["l2_busy"] = rng.integers(0, t0 + 40, mem["l2_busy"].shape
                                      ).astype(np.int32)
        mem["dram_busy"] = rng.integers(0, t0 + 80, mem["dram_busy"].shape
                                        ).astype(np.int32)
        mem["dram_row"] = rng.integers(-1, addr_hi // scfg.dram_row_div,
                                       mem["dram_row"].shape
                                       ).astype(np.int32)
    stats = {k: np.asarray(v) for k, v in state["stats"].items()}
    return req, mem, stats


def lane_axis(tree):
    """A dict of tensors with a leading lane axis of length 1."""
    return {k: v[None] for k, v in tree.items()}


def run_both(req, mem, stats, t0, sm_ids=None, jscfg=JSCFG, jdyn=JDYN,
             pscfg=PSCFG, pdyn=PDYN):
    jax_ids = None if sm_ids is None else jnp.asarray(sm_ids)
    want = J_MEM_PHASE(*(jax.tree_util.tree_map(jnp.asarray, x)
                         for x in (req, mem, stats)), jnp.int32(t0),
                       jscfg, jdyn, sm_ids=jax_ids)
    # the port's one-lane case: a leading lane axis of length 1
    got = PM.mem_phase(*(lane_axis(to_torch(x, "cpu"))
                         for x in (req, mem, stats)),
                       torch.tensor([t0], dtype=torch.int32), pscfg,
                       pdyn.map(lambda x: x[None]),
                       sm_ids=None if sm_ids is None
                       else torch.as_tensor(sm_ids)[None])
    got = tuple({k: v[0] for k, v in g.items()} for g in got)
    for w, g in zip(want, got):
        w = jax.tree_util.tree_map(np.asarray, w)
        g = to_numpy(g)
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].dtype == g[k].dtype, k
            assert np.array_equal(w[k], g[k]), (k, w[k], g[k])
    return got


@pytest.mark.parametrize("seed", range(8))
def test_mem_phase_equal_seeded(seed):
    rng = np.random.default_rng(seed)
    t0 = int(rng.integers(0, 8)) * JSCFG.quantum
    req, mem, stats = random_mem_inputs(rng, max(t0, JSCFG.quantum))
    run_both(req, mem, stats, t0)


@pytest.mark.parametrize("seed", range(6))
def test_mem_phase_equal_warm_state(seed):
    """A warm L2 (random tags, hits likely), busy queues, open DRAM rows,
    a small address range (many set and row conflicts), and a permuted SM
    order."""
    rng = np.random.default_rng(100 + seed)
    t0 = int(rng.integers(1, 50)) * JSCFG.quantum
    req, mem, stats = random_mem_inputs(rng, t0, addr_hi=256,
                                        random_mem=True)
    run_both(req, mem, stats, t0,
             sm_ids=rng.permutation(JSCFG.n_sm).astype(np.int32))


def test_mem_phase_equal_full_width():
    jscfg, jdyn = JC.split_config(JC.RTX3080TI)
    rng = np.random.default_rng(7)
    req, mem, stats = random_mem_inputs(rng, 160, scfg=jscfg,
                                        addr_hi=1 << 16, random_mem=True)
    run_both(req, mem, stats, 160, jscfg=jscfg, jdyn=jdyn,
             pscfg=PC.static_part(PC.RTX3080TI),
             pdyn=dyn_to_torch({k: np.asarray(v) for k, v in
                                jdyn.flat().items()}, "cpu"))


def test_dram_row_of_last_channel():
    """One stage-2 request per DRAM channel on TINY: channel 0 records its
    open row, the last channel keeps its old value because the invalid
    rows sorted after it write the old value to the same index."""
    ns, m = JSCFG.n_sm, JSCFG.mshr_per_sm
    req = {"stage": np.zeros((ns, m), np.int32),
           "addr": np.zeros((ns, m), np.int32),
           "t": np.zeros((ns, m), np.int32),
           "warp": np.zeros((ns, m), np.int32),
           "is_store": np.zeros((ns, m), bool)}
    # slices 0..3 map to channels 0,0,1,1 on TINY; rows are addr // 64
    req["stage"][0, 0] = req["stage"][1, 0] = 2
    req["addr"][0, 0] = 1000      # slice 0 → channel 0, row 15
    req["addr"][1, 0] = 1002      # slice 2 → channel 1, row 15
    state = jax.tree_util.tree_map(np.asarray, JS.init_state(JSCFG))
    stats = {k: np.asarray(v) for k, v in state["stats"].items()}
    _, mem, _ = run_both(req, dict(state["mem"]), stats, 0)
    assert mem["dram_row"].tolist() == [15, -1]


def test_ties_in_service_order():
    """Every request on one L2 slice at one time, many to one address and
    one set: the order falls back to the row id (stable sorts), hits and
    victims to the first way, the inserted tag to the last row."""
    ns, m = JSCFG.n_sm, JSCFG.mshr_per_sm
    rng = np.random.default_rng(3)
    req = {"stage": np.ones((ns, m), np.int32),
           "addr": (rng.integers(0, 3, (ns, m)) * 64 * JSCFG.l2_slices
                    ).astype(np.int32),
           "t": np.full((ns, m), 32, np.int32),
           "warp": np.zeros((ns, m), np.int32),
           "is_store": np.zeros((ns, m), bool)}
    req["stage"][::2, ::3] = 2
    state = jax.tree_util.tree_map(np.asarray, JS.init_state(JSCFG))
    mem = dict(state["mem"])
    mem["l2_tag"] = mem["l2_tag"].copy()
    # duplicate tags in one set
    mem["l2_tag"][0, 0] = [0, 0, 64 * JSCFG.l2_slices, -1]
    stats = {k: np.asarray(v) for k, v in state["stats"].items()}
    run_both(req, mem, stats, 32)


@pytest.mark.parametrize("seed", range(4))
def test_seg_maxplus_equal(seed):
    rng = np.random.default_rng(seed)
    n = 200
    seg_start = rng.random(n) < 0.15
    seg_start[0] = True
    service = rng.integers(0, 30, n).astype(np.int32)
    arrival = rng.integers(0, 1 << 20, n).astype(np.int32)
    want = np.asarray(jax.jit(JM._seg_maxplus)(
        jnp.asarray(seg_start), jnp.asarray(service), jnp.asarray(arrival)))
    got = PM._seg_maxplus(*(torch.as_tensor(x) for x in
                            (seg_start, service, arrival)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_lex_sort_equal(seed):
    rng = np.random.default_rng(seed)
    n = 256
    primary = rng.integers(0, 5, n).astype(np.int32)
    secondary = rng.integers(-3, 16, n).astype(np.int32)
    tertiary = rng.permutation(n).astype(np.int32)
    valid = rng.random(n) < 0.7
    args = (primary, secondary, tertiary, valid)
    want = np.asarray(JM._lex_sort(*(jnp.asarray(x) for x in args)))
    got = PM._lex_sort(*(torch.as_tensor(x) for x in args))
    assert np.array_equal(got.numpy(), want)
