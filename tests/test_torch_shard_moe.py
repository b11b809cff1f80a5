"""The MoE models' token groups in the port's sharded train step
(train/train_step.py), against the reference's token-grouped computation:
the JAX package's step under a ctx of the same axis sizes whose sharding
hints are dropped, so that it runs on one device with the reference's G
groups (``repro/models/layers/moe.py:apply_moe``), their capacities, and
the balance loss over all of them.

  · reduced arctic-480b and jamba-v0.1-52b, 3 steps on CPU meshes: loss,
    ce and aux within 1e-5 relative, grad_norm within 1e-4, parameters
    within 1e-4 of each leaf's largest magnitude; with a batch the
    positions divide (G = dp, each position its rows; meshes (4, 1) and
    (2, 2, 1)), a batch they do not (3 rows on 2 positions: replicated,
    G from the global token count) and fewer tokens than dp · top_k
    (G = 1);
  · the MoE layer's G groups in one dispatch against each group's tokens
    through the layer alone, and against the reference's layer.
"""
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models.layers import moe as JM
from repro.parallelism.ctx import ShardCtx as JShardCtx
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import lm_params_to_torch
from repro_torch.data.pipeline import make_batch_np
from repro_torch.models.layers import moe as PM
from test_torch_shard_train import (DATA_SEED, KW, METRIC_RTOL, PARAM_TOL,
                                    assert_rows_close, cpu_ctx, leaf_err,
                                    params_of, rel, run, weights)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclass(frozen=True)
class FakeMesh:
    shape_dict: dict

    @property
    def shape(self):
        return self.shape_dict

    @property
    def axis_names(self):
        return tuple(self.shape_dict)


@dataclass(frozen=True)
class UnhintedCtx(JShardCtx):
    """The reference's ctx over a mesh's axis sizes with its sharding
    hints dropped: its layers compute what the sharded step computes
    (token groups, capacities, the balance loss), on one device."""

    def hint(self, x, *spec):
        return x


def grouped_reference(jcfg, tree, mesh_shape, shape, n_steps):
    axes = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    ctx = UnhintedCtx(mesh=FakeMesh(dict(zip(axes, mesh_shape))),
                      batch_axes=axes[:-1], tp_axis="model")
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**KW), ctx))
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    state = {"params": jt,
             "opt": {k: jax.tree_util.tree_map(jnp.zeros_like, jt)
                     for k in ("m", "v")},
             "step": jnp.zeros((), jnp.int32)}
    rows = []
    for step in range(n_steps):
        batch = make_batch_np(jcfg, shape, DATA_SEED, step)
        state, m = jstep(state, jax.tree_util.tree_map(jnp.asarray, batch))
        rows.append({k: float(x) for k, x in m.items()})
    return rows, state


def flat_ref(tree, cfg) -> dict:
    """The reference's parameter tree as the port's {name: array}."""
    return {k: v.numpy() for k, v in lm_params_to_torch(
        jax.tree_util.tree_map(np.asarray, tree), cfg, "cpu").items()}


CASES = {"4x1": ((4, 1), 4, 32, 4),        # each position its rows: G = 4
         "2x2x1": ((2, 2, 1), 4, 32, 4),
         "replicated": ((2, 1), 3, 32, 2),  # 3 rows on 2 positions: G = 2
         "one_group": ((2, 1), 2, 1, 1)}    # 2 tokens < dp * top_k: G = 1


@pytest.mark.parametrize("arch,case", [
    *(("arctic-480b", c) for c in CASES),
    # jamba's Mamba layers cost ~20 s a case here: the two placements
    ("jamba-v0.1-52b", "4x1"), ("jamba-v0.1-52b", "replicated")])
def test_moe_step_follows_the_reference_groups(arch, case):
    mesh, b, s, groups = CASES[case]
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    shape = ShapeSpec("t", s, b, "train")
    dp = int(np.prod(mesh[:-1]))
    assert PM.moe_groups(dp, b * s, cfg.moe.top_k) == groups
    tree = weights(cfg)
    want_rows, want = grouped_reference(jcfg, tree, mesh, shape, 3)
    rows, state = run(cfg, tree, cpu_ctx(mesh), shape, 3)
    assert_rows_close(rows, want_rows, aux=True)
    assert all(r["aux"] > 0 for r in rows)
    err, leaf = leaf_err(params_of(state), flat_ref(want["params"], cfg))
    assert err <= PARAM_TOL, (leaf, err)


@pytest.mark.parametrize("groups", [2, 4])
def test_moe_groups_in_one_dispatch(groups):
    """moe_layer over G groups == each group's tokens through the layer
    alone (their outputs concatenated, their statistics summed), and ==
    the reference's layer with G groups."""
    cfg = get_reduced("arctic-480b")
    tree = weights(cfg)["groups"][0]
    p = {k: torch.from_numpy(np.asarray(v)[0]) for k, v in
         tree["moe"].items() if not isinstance(v, dict)}
    p.update({k: {n: torch.from_numpy(np.asarray(a)[0]) for n, a in
                  v.items()} for k, v in tree["moe"].items()
              if isinstance(v, dict)})
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model), dtype=np.float32))
    y, stats = PM.moe_layer(p, x, cfg=cfg, groups=groups)
    rows = 4 // groups
    parts = [PM.moe_layer(p, x[i * rows:(i + 1) * rows], cfg=cfg)
             for i in range(groups)]
    assert torch.allclose(y, torch.cat([q[0] for q in parts]), rtol=0,
                          atol=1e-6)
    assert torch.equal(stats[0], sum(q[1][0] for q in parts))
    assert torch.allclose(stats[1], sum(q[1][1] for q in parts), rtol=1e-6)
    ctx = UnhintedCtx(mesh=FakeMesh({"data": groups, "model": 1}),
                      batch_axes=("data",), tp_axis="model")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    jy, jaux = JM.apply_moe(jp, jnp.asarray(x.numpy()),
                            cfg=jget_reduced("arctic-480b"), ctx=ctx)
    aux = PM.balance_loss(stats, x.shape[0] * x.shape[1],
                          cfg.moe.n_experts)
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= \
        1e-5 * np.abs(np.asarray(jy)).max()
    assert rel(float(aux), float(jaux)) <= METRIC_RTOL


