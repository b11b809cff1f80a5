"""Simulator state: every leaf of the port's ``init_state`` and
``reset_for_kernel`` equals the JAX package's (keys, shapes, dtypes,
values), and the padded kernel layout stacks identically."""
import jax
import numpy as np
import pytest

import repro.core.batch as JB
import repro.sim.config as JC
import repro.sim.state as JS
import repro.workloads.synthetic as JW
import repro_torch.core.batch as PB
import repro_torch.sim.config as PC
import repro_torch.sim.state as PS
import repro_torch.workloads.synthetic as PW
from repro_torch.convert import stack_lanes, to_numpy, to_torch


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_trees_equal(want, got):
    want, got = flat_leaves(want), flat_leaves(got)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert want[k].shape == got[k].shape, k
        assert np.array_equal(want[k], got[k]), k


def take_lane(tree, i):
    if isinstance(tree, dict):
        return {k: take_lane(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.mark.parametrize("cfg", ["TINY", "RTX3080TI"])
def test_init_state_equal(cfg):
    """Every lane of the port's lane-batched state is the reference's
    state."""
    jstate = JS.init_state(JC.static_part(getattr(JC, cfg)))
    pstate = to_numpy(PS.init_state(PC.static_part(getattr(PC, cfg)), "cpu",
                                    3))
    for lane in range(3):
        assert_trees_equal(jstate, take_lane(pstate, lane))


def random_state(rng, scfg):
    """A JAX-side state with every leaf randomized (as numpy)."""
    base = jax.tree_util.tree_map(np.asarray, JS.init_state(scfg))
    out = {}
    for part, leaves in base.items():
        out[part] = {}
        for k, v in leaves.items():
            if v.dtype == bool:
                out[part][k] = rng.random(v.shape) < 0.5
            else:
                out[part][k] = rng.integers(-1, 100, v.shape).astype(
                    v.dtype)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_reset_for_kernel_equal(seed):
    scfg = JC.static_part(JC.TINY)
    state = random_state(np.random.default_rng(seed), scfg)
    want = JS.reset_for_kernel(
        jax.tree_util.tree_map(jax.numpy.asarray, state), scfg)
    # the port's one-lane case: a leading lane axis of length 1
    got = PS.reset_for_kernel(to_torch(stack_lanes([state]), "cpu"),
                              PC.static_part(PC.TINY))
    assert_trees_equal(want, take_lane(to_numpy(got), 0))


@pytest.mark.parametrize("name", ["gaussian", "myocyte", "conv"])
def test_stack_kernels_equal(name):
    jpacks = [k.pack() for k in JW.make_workload(name, 0.05).kernels]
    ppacks = [k.pack("cpu") for k in PW.make_workload(name, 0.05).kernels]
    n_instr = max(int(p["ops"].shape[0]) for p in jpacks) + 3
    n_kernels = len(jpacks) + 2
    assert_trees_equal(
        JB.stack_kernels(jpacks, n_instr=n_instr, n_kernels=n_kernels),
        to_numpy(PB.stack_kernels(ppacks, n_instr=n_instr,
                                  n_kernels=n_kernels)))


def test_batch_errors():
    ppacks = [k.pack("cpu") for k in PW.make_workload("nn", 0.5).kernels]
    with pytest.raises(ValueError, match="empty kernel list"):
        PB.stack_kernels([])
    with pytest.raises(ValueError, match="n_kernels=0"):
        PB.stack_kernels(ppacks, n_kernels=0)
    with pytest.raises(ValueError, match="n_instr_max=2"):
        PB.pad_packed(ppacks[0], 2)
    wide = PW.make_workload("cut_1", 1.0)      # 8 warps per CTA
    with pytest.raises(ValueError, match="warps_per_cta=8 > warps_per_sm=4"):
        PB.check_workload_fits(
            PC.static_part(PC.GPUConfig(warps_per_sm=4, n_subcores=2)),
            wide)
