"""Kernel traces and workloads: the port's ``pack()`` and ``gen_address``
against the JAX package's, exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.trace as JT
import repro.sim.workloads as JZ
import repro.workloads.synthetic as JS
import repro_torch.sim.trace as PT
import repro_torch.sim.workloads as PZ
import repro_torch.workloads.synthetic as PS
from repro_torch.convert import to_numpy

SYNTHETIC = JS.ALL_BENCHMARKS + ["stencil_bar"]


def assert_packs_equal(jw, pw):
    assert jw.name == pw.name
    assert len(jw.kernels) == len(pw.kernels)
    for jk, pk in zip(jw.kernels, pw.kernels):
        assert jk.name == pk.name
        jp = {k: np.asarray(v) for k, v in jk.pack().items()}
        pp = to_numpy(pk.pack("cpu"))
        assert jp.keys() == pp.keys()
        for k in jp:
            assert jp[k].dtype == pp[k].dtype, k
            assert jp[k].shape == pp[k].shape, k
            assert np.array_equal(jp[k], pp[k]), k


def test_suites_equal():
    assert PS.SUITES == JS.SUITES
    assert PS.ALL_BENCHMARKS == JS.ALL_BENCHMARKS
    assert PZ.zoo_names() == sorted(n for n in JZ.zoo_names()
                                    if not n.startswith("trace:"))


@pytest.mark.parametrize("scale", [0.01, 0.5])
@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_pack_equal(name, scale):
    assert_packs_equal(JS.make_workload(name, scale),
                       PS.make_workload(name, scale))


@pytest.mark.parametrize("scale", [0.03, 1.0])
@pytest.mark.parametrize("name", sorted(
    n for n in JZ.zoo_names() if not n.startswith("trace:")))
def test_zoo_pack_equal(name, scale):
    assert_packs_equal(JZ.zoo_workload(name, scale),
                       PZ.zoo_workload(name, scale))
    assert_packs_equal(JZ.resolve_workload(f"zoo:{name}", scale),
                       PZ.resolve_workload(f"zoo:{name}", scale))


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        PS.make_workload("nope")
    with pytest.raises(KeyError, match="nope"):
        PZ.zoo_workload("nope")


I32 = np.iinfo(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_gen_address_equal(seed):
    """Random (mode, param, gwarp, pc), with negative gwarp (an unselected
    warp has cta = -1) and params whose products overflow int32."""
    rng = np.random.default_rng(seed)
    n = 4096
    mode = rng.integers(0, 4, n).astype(np.int32)
    param = np.concatenate([
        rng.integers(0, 200, n // 2),
        rng.integers(I32.min, I32.max, n // 2, endpoint=True)]).astype(
            np.int32)
    gwarp = rng.integers(-300, 1 << 20, n).astype(np.int32)
    gwarp[:64] = rng.integers(I32.min, 0, 64)
    pc = rng.integers(0, 1 << 16, n).astype(np.int32)
    for mem_blocks in (1 << 22, 4099, 7):
        want = np.asarray(JT.gen_address(
            jnp.asarray(mode), jnp.asarray(param), jnp.asarray(gwarp),
            jnp.asarray(pc), mem_blocks))
        got = PT.gen_address(*(torch.as_tensor(x) for x in
                               (mode, param, gwarp, pc)), mem_blocks)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), mem_blocks
        assert (want >= 0).all()


def test_wrap_i32_matches_int32_wraparound():
    x = np.array([0, 1, -1, I32.max, I32.min, 1 << 40, -(1 << 40) - 5,
                  (1 << 33) + 7], np.int64)
    assert np.array_equal(PT.wrap_i32(torch.as_tensor(x)).numpy(),
                          x.astype(np.int32))
