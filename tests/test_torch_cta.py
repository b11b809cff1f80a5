"""CTA dispatch: the port's ``cta_issue`` against the JAX package's on
seeded warp tables, exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.sim.config as JC
import repro.sim.cta as JCTA
import repro_torch.sim.config as PC
import repro_torch.sim.cta as PCTA
from repro_torch.convert import to_numpy, to_torch


def random_inputs(rng, scfg):
    ns, w = scfg.n_sm, scfg.warps_per_sm
    n_instr = int(rng.integers(1, 30))
    warp = {
        "pc": rng.integers(0, n_instr + 2, (ns, w)).astype(np.int32),
        "active": rng.random((ns, w)) < rng.random(),
        "ready_at": rng.integers(0, 500, (ns, w)).astype(np.int32),
        "pending": (rng.random((ns, w)) < 0.3).astype(np.int32),
        "wait_mem": rng.random((ns, w)) < 0.3,
        "wait_bar": rng.random((ns, w)) < 0.2,
        "cta": rng.integers(-1, 50, (ns, w)).astype(np.int32),
        "wic": rng.integers(0, 4, (ns, w)).astype(np.int32),
    }
    n_ctas = int(rng.integers(0, 3 * ns * scfg.max_cta_per_sm))
    ctrl = {
        "cycle": np.int32(rng.integers(0, 10_000)),
        "next_cta": np.int32(rng.integers(0, n_ctas + 2)),
        "rr": np.int32(rng.integers(0, ns)),
        "done_cycle": np.int32(-1),
        "sm_ids": rng.permutation(ns).astype(np.int32),
    }
    stats = {"ctas_launched": np.int32(rng.integers(0, 100)),
             "l2_hit": np.int32(0)}
    trace = {"n_instr": np.int32(n_instr), "n_ctas": np.int32(n_ctas),
             "warps_per_cta": np.int32(rng.integers(1, 5))}
    return warp, ctrl, stats, trace


@pytest.mark.parametrize("cfg", ["TINY", "RTX3080TI"])
@pytest.mark.parametrize("seed", range(6))
def test_cta_issue_equal(cfg, seed):
    jscfg = JC.static_part(getattr(JC, cfg))
    pscfg = PC.static_part(getattr(PC, cfg))
    args = random_inputs(np.random.default_rng(seed), jscfg)
    want = jax.jit(JCTA.cta_issue, static_argnums=(4,))(
        *jax.tree_util.tree_map(jnp.asarray, args), jscfg)
    got = PCTA.cta_issue(*(to_torch(x, "cpu") for x in args), pscfg)
    for w, g in zip(want, got):
        w = jax.tree_util.tree_map(np.asarray, w)
        g = to_numpy(g)
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].dtype == g[k].dtype, k
            assert np.array_equal(w[k], g[k]), (k, w[k], g[k])


def test_dispatch_fills_every_sm_round_robin():
    """A fresh RTX 3080 Ti with more CTAs than SMs: one CTA per SM per
    round, starting at SM rr, warp slots lowest first."""
    pscfg = PC.static_part(PC.RTX3080TI)
    import repro_torch.sim.state as PS
    st = PS.init_state(pscfg, "cpu")
    st["ctrl"]["rr"].fill_(5)
    trace = to_torch({"n_instr": np.int32(8), "n_ctas": np.int32(84),
                      "warps_per_cta": np.int32(4)}, "cpu")
    warp, ctrl, stats = PCTA.cta_issue(st["warp"], st["ctrl"], st["stats"],
                                       trace, pscfg)
    assert int(stats["ctas_launched"]) == 84
    assert int(ctrl["next_cta"]) == 84
    cta = warp["cta"].numpy()
    assert (cta[:, :4] == cta[:, :1]).all()           # one CTA, 4 slots
    assert sorted(cta[:, 0]) == list(range(80))        # round 1: all SMs
    assert cta[5, 0] == 0 and cta[4, 0] == 79          # deal from SM 5
    assert sorted(cta[cta[:, 4] >= 0, 4]) == [80, 81, 82, 83]
