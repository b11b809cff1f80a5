"""The port's sharding rules (``repro_torch.parallelism``) against the JAX
package's, mirroring tests/test_sharding_rules.py: a fake mesh (axis
sizes only, no devices) at both production shapes, every config.

  · ``ShardCtx``: dp_size, tp_size, batch, tp_if, dp_if and ep_axes equal
    the reference's over a grid of axis sizes;
  · every parameter spec and every ZeRO-1 moment spec equals the
    reference's for the same leaf (a port layer's spec is its stacked
    leaf's, the layer axis first) and divides its dimension; the shapes
    come from a model on the ``meta`` device, so the published configs
    of every size fit;
  · every cache spec at (128, 1024) and (1, 4096) likewise, at both
    production shapes;
  · the production meshes, ``make_ctx`` and the placement's refusals.
"""
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.models import factory as JF
from repro.parallelism import sharding as jshd
from repro.parallelism.ctx import ShardCtx as JShardCtx
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import (make_ctx, make_production_mesh,
                                     make_train_mesh)
from repro_torch.models import factory
from repro_torch.parallelism import sharding as shd
from repro_torch.parallelism.ctx import NULL_CTX, ShardCtx


@dataclass(frozen=True)
class FakeMesh:
    shape_dict: dict

    @property
    def shape(self):
        return self.shape_dict

    @property
    def axis_names(self):
        return tuple(self.shape_dict)


def ctx_pair(sizes: dict, batch_axes, tp_axis):
    """The same fake mesh's ctx in both packages."""
    mesh = FakeMesh(dict(sizes))
    return (ShardCtx(mesh=mesh, batch_axes=batch_axes, tp_axis=tp_axis),
            JShardCtx(mesh=mesh, batch_axes=batch_axes, tp_axis=tp_axis))


def production_ctx(multi: bool):
    if multi:
        return ctx_pair({"pod": 2, "data": 16, "model": 16},
                        ("pod", "data"), "model")
    return ctx_pair({"data": 16, "model": 16}, ("data",), "model")


GRID = [({"data": d, "model": m}, ("data",), "model")
        for d in (1, 2, 4, 16) for m in (1, 2, 16)] + \
    [({"pod": p, "data": d, "model": m}, ("pod", "data"), "model")
     for p in (1, 2) for d in (2, 16) for m in (1, 16)] + \
    [({"data": 4}, ("data",), None)]


@pytest.mark.parametrize("sizes,batch_axes,tp_axis", GRID)
def test_shard_ctx_matches_reference(sizes, batch_axes, tp_axis):
    ctx, jctx = ctx_pair(sizes, batch_axes, tp_axis)
    assert (ctx.dp_size, ctx.tp_size, ctx.batch) == \
        (jctx.dp_size, jctx.tp_size, jctx.batch)
    for n in (1, 2, 3, 12, 16, 32, 56, 128, 256, 4096):
        assert ctx.tp_if(n) == jctx.tp_if(n), n
        assert ctx.dp_if(n) == jctx.dp_if(n), n
    for e, f in ((16, 14336), (128, 4864), (256, 2048), (8, 3), (6, 32)):
        assert ctx.ep_axes(e, f) == jctx.ep_axes(e, f), (e, f)
    assert (NULL_CTX.dp_size, NULL_CTX.tp_size, NULL_CTX.batch,
            NULL_CTX.ep_axes(8, 8)) == (1, 1, None, (None, None))


@lru_cache(maxsize=None)
def ref_param_shapes(arch):
    return jax.eval_shape(lambda: JF.init_params(
        jax.random.PRNGKey(0), jget_config(arch), jnp.bfloat16,
        max_seq=4096))


def ref_by_path(tree, specs) -> dict:
    """{reference path names: (shape, spec tuple)}."""
    flat_x = jax.tree_util.tree_leaves_with_path(tree)
    flat_s = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, P))
    assert len(flat_x) == len(flat_s)
    return {tuple(jshd._path_names(path)): (tuple(x.shape), tuple(s))
            for (path, x), s in zip(flat_x, flat_s)}


def port_by_path(tree, specs, names=()) -> dict:
    """{path names: (shape, spec)} of the port's cache and its specs."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(port_by_path(tree[k], specs[k], names + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, (t, s) in enumerate(zip(tree, specs)):
            out.update(port_by_path(t, s, names + (f"[{i}]",)))
        return out
    return {names: (tuple(tree.shape), specs)}


def check_divides(spec, shape, ctx):
    assert len(spec) == len(shape), (spec, shape)
    for entry, dim in zip(spec, shape):
        if entry is None:
            continue
        size = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            size *= ctx.mesh.shape[a]
        assert dim % size == 0, (shape, spec)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("multi", [False, True])
def test_param_and_moment_specs_match_reference(arch, multi):
    cfg = get_config(arch)
    ctx, jctx = production_ctx(multi)
    jshapes = ref_param_shapes(arch)
    jspecs = jshd.param_pspecs(jshapes, jget_config(arch), jctx)
    want = ref_by_path(jshapes, jspecs)
    want_m = ref_by_path(jshapes, jshd.moments_pspecs(jspecs, jshapes,
                                                      jctx))
    shapes = factory.param_shapes(cfg, torch.bfloat16)
    specs = shd.param_pspecs(shapes, cfg, ctx)    # KeyError = missing rule
    mspecs = shd.moments_pspecs(specs, shapes, ctx)
    ref_shapes = shd.ref_shapes(shapes)
    seen = set()
    for name in shapes:
        path = tuple(shd._ref_path(name)[0])
        shape, spec = want[path]
        assert ref_shapes[name] == shape, (name, ref_shapes[name], shape)
        assert specs[name] == spec, (name, specs[name], spec)
        assert mspecs[name] == want_m[path][1], (name, mspecs[name],
                                                 want_m[path][1])
        check_divides(specs[name], shape, ctx)
        check_divides(mspecs[name], shape, ctx)
        seen.add(path)
    assert seen == set(want)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("multi", [False, True])
def test_cache_specs_match_reference(arch, multi):
    cfg = get_config(arch)
    ctx, jctx = production_ctx(multi)
    for batch, seqlen in ((128, 1024), (1, 4096)):
        jcache = jax.eval_shape(lambda: JF.init_cache(
            jget_config(arch), batch, seqlen, jnp.bfloat16))
        want = ref_by_path(jcache, jshd.cache_pspecs(
            jcache, jget_config(arch), jctx))
        cache = factory.init_cache(cfg, batch, seqlen, torch.bfloat16,
                                   device="meta")
        specs = shd.cache_pspecs(cache, cfg, ctx)
        got = port_by_path(cache, specs)
        assert got.keys() == want.keys()
        for path, (shape, spec) in got.items():
            assert (shape, spec) == want[path], (path, shape, spec,
                                                 want[path])
            check_divides(spec, shape, ctx)


def test_batch_and_logits_specs_match_reference():
    ctx, jctx = production_ctx(True)
    cfg = get_config("qwen2-vl-2b")
    batch = {"embeds": torch.empty((64, 8, 4), device="meta"),
             "labels": torch.empty((64, 8), device="meta"),
             "odd": torch.empty((3, 8), device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)
              for k, x in batch.items()}
    want = jshd.batch_pspecs(jbatch, jctx)
    assert shd.batch_pspecs(batch, ctx) == {k: tuple(s)
                                            for k, s in want.items()}
    for b in (1, 32, 64):
        assert shd.logits_pspec(cfg, ctx, b) == tuple(jshd.logits_pspec(
            jget_config("qwen2-vl-2b"), jctx, b))


def test_production_mesh_and_ctx():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16),
                                ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        assert mesh.devices.shape == shape and mesh.axis_names == axes
        ctx = make_ctx(mesh)
        assert ctx.batch_axes == axes[:-1] and ctx.tp_axis == "model"
        assert (ctx.dp_size, ctx.tp_size) == (shape[-2] * (2 if multi
                                                           else 1), 16)
        devs = [torch.device("cpu")] * (512 if multi else 256)
        assert make_production_mesh(multi_pod=multi,
                                    devices=devs).devices.shape == shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_production_mesh()
    mesh = make_train_mesh((2, 2, 1), device="cpu")
    assert mesh.axis_names == ("pod", "data", "model")
    assert make_ctx(mesh).batch == ("pod", "data")


def test_placement_refuses_a_model_axis():
    mesh = make_train_mesh((1, 2), device="cpu")
    ctx = make_ctx(mesh)
    x = {"w": torch.zeros((4, 6))}
    with pytest.raises(NotImplementedError, match="11d.5b"):
        shd.shard_tree(x, {"w": (None, "model")}, mesh)
    # a leaf replicated over the model axis places: one copy, two views
    got = shd.shard_tree(x, {"w": (None, None)}, mesh)["w"]
    assert all(b.data_ptr() == x["w"].data_ptr() for b in got.blocks)
    assert ctx.tp_size == 2
