"""The port's sharded train step against the JAX package's own sharded
step on 4 host devices (``check_against_reference`` of
test_torch_shard_train.py: a subprocess of the reference's step placed by
``param_pspecs``/``moments_pspecs``/``batch_pspecs``, 2 steps, metrics,
parameters and each moment block's shape):

  · the data axes: reduced arctic-480b (G = 4) and qwen2-vl-2b on a
    (4, 1) mesh;
  · the model axis of the MoE, MLA and jamba families: experts placed by
    ``ctx.ep_axes`` ('2d' on (2, 2), 'full' on (1, 4)), MLA's heads and
    Mamba's d_inner split.

These are the slowest cases of the sharded step's tests (each runs the
JAX package's step in a subprocess); they stand in a file of their own so
that ``pytest --dist loadfile`` gives them a worker of their own.
"""
import pytest
import torch

from test_torch_shard_train import check_against_reference


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["arctic-480b", "qwen2-vl-2b"])
def test_matches_the_reference_sharded_step(arch, tmp_path):
    check_against_reference(arch, (4, 1), tmp_path)


@pytest.mark.parametrize("arch,mesh", [
    ("arctic-480b", (2, 2)), ("deepseek-v3-671b", (1, 4)),
    ("jamba-v0.1-52b", (2, 2))], ids=["arctic-2d", "deepseek-full",
                                      "jamba-2d"])
def test_expert_placement_matches_the_reference_sharded_step(arch, mesh,
                                                             tmp_path):
    """The model axis of the MoE, MLA and jamba families: experts placed
    by ``ctx.ep_axes`` ('2d' on (2, 2), 'full' on (1, 4)), MLA's heads
    and Mamba's d_inner split, against the reference's step on a host
    mesh of that shape."""
    check_against_reference(arch, mesh, tmp_path)
