"""The fused SM-quantum kernel's wrapper on the CPU: the SM phase
(``sim/smcore.py:sm_quantum``) runs the eager cycle loop (the kernel's
plain version) on CPU tensors and never reaches the kernel's launcher, the
state dicts pack into the kernel's 26 leaves and back, and the wrapper
refuses every device but CUDA.  The plain version itself is held bit-exact
against the JAX package by tests/test_torch_smcore.py; the kernel against
it on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core.parallel as PP
import repro_torch.sim.config as PC
from repro_torch.convert import (QUANTUM_T0, random_quantum_inputs,
                                 stack_lanes, to_numpy, to_torch)
from repro_torch.kernels.sm_quantum import kernel as K
from repro_torch.sim import smcore
from repro_torch.sim.state import init_state

SC4 = dict(n_sm=4, warps_per_sm=16, n_subcores=4, mshr_per_sm=6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, pcfg, sched, ragged=False):
    """One lane of seeded quantum inputs, with its lane axis."""
    inputs = random_quantum_inputs(np.random.default_rng(seed),
                                   PC.static_part(pcfg), ragged=ragged)
    _, dyn = PC.split_config(pcfg, {"sched": PC.SCHEDULERS[sched]},
                             device="cpu")
    return ([to_torch(stack_lanes([x]), "cpu") for x in inputs],
            torch.tensor([QUANTUM_T0], dtype=torch.int32),
            dyn.map(lambda x: x[None]))


@pytest.mark.parametrize("mode", ["seq", "vmap"])
@pytest.mark.parametrize("sched", ["gto", "lrr"])
def test_cpu_runs_eager_loop_not_the_launcher(monkeypatch, mode, sched):
    def refuse():
        raise AssertionError("the kernel's launcher was reached on CPU")
    monkeypatch.setattr(K, "_launcher", refuse)
    pcfg = dataclasses.replace(PC.TINY, **SC4) if mode == "seq" else PC.TINY
    (warp, sm, req, stats, trace), t0, dyn = _inputs(3, pcfg, sched,
                                                     ragged=True)
    before = K.sm_quantum.launches
    got = PP.make_sm_runner(pcfg, mode)(warp, sm, req, stats, trace, t0, dyn)
    assert K.sm_quantum.launches == before
    scfg = PC.static_part(pcfg)
    if mode == "seq":
        parts = [smcore.sm_quantum_eager(
            *({k: v[:, i:i + 1] for k, v in p.items()}
              for p in (warp, sm, req, stats)), trace, t0, scfg, dyn)
            for i in range(scfg.n_sm)]
        want = tuple({k: torch.cat([o[j][k] for o in parts], 1)
                      for k in parts[0][j]} for j in range(4))
    else:
        want = smcore.sm_quantum_eager(warp, sm, req, stats, trace, t0,
                                       scfg, dyn)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]), k
    # the quantum did run: the seeded state issues
    assert (got[3]["issued"] > stats["issued"]).any()


@pytest.mark.parametrize("cfg", [PC.TINY, PC.RTX3080TI,
                                 dataclasses.replace(PC.TINY, **SC4)])
def test_pack_unpack_round_trip(cfg):
    scfg = PC.static_part(cfg)
    st = init_state(scfg, "cpu", 2)
    parts = (st["warp"], st["sm"], st["req"], st["stats_sm"])
    leaves = K.pack_state(*parts)
    assert len(leaves) == 26
    # the kernel's order, shapes and dtypes, behind the lane axis
    shapes = K.per_sm_shapes(scfg)
    assert list(shapes) == [(g, k) for g, keys in K.LEAVES for k in keys]
    for ((g, k), shape), x in zip(shapes.items(), leaves):
        assert x is st[g][k]
        assert tuple(x.shape) == (2, scfg.n_sm, *shape), (g, k)
        assert (x.dtype == torch.bool) == ((g, k) in K.BOOL_LEAVES), (g, k)
    back = K.unpack_state(leaves)
    for p, b in zip(parts, back):
        assert set(b) == set(p)
        assert all(b[k] is p[k] for k in p)
    # the per-SM sizes the kernel is given, and the shared-memory budget:
    # every leaf of one SM as int32, W scratch
    assert K.leaf_counts(scfg) == tuple(x[0, 0].numel() for x in leaves)
    words = sum(K.leaf_counts(scfg)) + scfg.warps_per_sm
    assert K.shared_bytes(scfg) == 4 * words <= K.MAX_SHARED


def test_pack_rejects_a_missing_leaf():
    st = init_state(PC.static_part(PC.TINY), "cpu")
    warp = dict(st["warp"])
    del warp["wic"]
    with pytest.raises(ValueError, match="warp has keys"):
        K.pack_state(warp, st["sm"], st["req"], st["stats_sm"])


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_refuses_a_device_without_kernel(monkeypatch, device):
    """The wrapper is CUDA-only: the CPU's plain version is chosen by the
    SM phase, never by the wrapper."""
    def refuse():
        raise AssertionError("the kernel's launcher was reached")
    monkeypatch.setattr(K, "_launcher", refuse)
    (warp, sm, req, stats, trace), t0, dyn = _inputs(0, PC.TINY, "gto")
    warp = {k: v.to(device) for k, v in warp.items()}
    before = K.sm_quantum.launches
    with pytest.raises(ValueError, match=f"no kernel for device {device}"):
        K.sm_quantum(warp, sm, req, stats, trace, t0,
                     PC.static_part(PC.TINY), dyn)
    assert K.sm_quantum.launches == before


def test_cpu_leaves_inputs_unchanged():
    """The quantum returns fresh state: the inputs read the same after."""
    (warp, sm, req, stats, trace), t0, dyn = _inputs(4, PC.TINY, "gto")
    before = [to_numpy(p) for p in (warp, sm, req, stats)]
    smcore.sm_quantum(warp, sm, req, stats, trace, t0,
                      PC.static_part(PC.TINY), dyn)
    for b, p in zip(before, (warp, sm, req, stats)):
        for k in b:
            assert np.array_equal(b[k], p[k].numpy()), k
