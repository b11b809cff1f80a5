"""The port's CUDA path, on the card: the sm_issue kernel against its plain
PyTorch version, the wrapper's input checks, and one simulation on the
card against the same simulation on the CPU.

Every test here carries the `cuda` marker and skips without a CUDA card.
This file imports neither jax nor repro, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import stats as S
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.kernels.sm_issue import kernel as K
from repro_torch.sim.config import N_CLASSES, N_UNITS, RTX3080TI, TINY
from repro_torch.sim.workloads import resolve_workload

pytestmark = pytest.mark.cuda

# (n_sm, warps per SM, sub-cores): TINY, RTX 3080 Ti, and odd widths
SHAPES = ((8, 8, 2), (80, 48, 4), (4, 16, 4), (3, 96, 3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_issue kernel has no CPU mode")
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


@pytest.mark.parametrize("cfg,bench,scale", [(TINY, "zoo:mixed", 0.01),
                                             (RTX3080TI, "nn", 0.05)])
def test_simulate_on_card_equals_cpu(cuda, cfg, bench, scale):
    w = resolve_workload(bench, scale)
    before = K.issue_select.launches
    on_card = S.finalize(simulate(w, cfg, make_sm_runner(cfg, "vmap")))
    assert K.issue_select.launches > before
    on_cpu = S.finalize(simulate(w, cfg, make_sm_runner(cfg, "vmap"),
                                 device="cpu"))
    assert S.comparable(on_card) == S.comparable(on_cpu)
    assert on_card["timeouts"] == on_cpu["timeouts"] == 0
