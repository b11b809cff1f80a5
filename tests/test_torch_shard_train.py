"""The data axes of the port's sharded train step (``make_train_step(cfg,
opt_cfg, ctx)`` with ``ctx = make_ctx(mesh)``, train/train_step.py) on
meshes of the CPU, every position on the one CPU:

  · reduced qwen2-vl-2b, minitron-8b, rwkv6-1.6b and whisper-base, 3
    steps on meshes (2, 1), (4, 1) and (2, 2, 1) against the port's
    unsharded step from the same weights and batches: loss and ce within
    1e-5 relative, grad_norm within 1e-4, the parameters and the gathered
    ZeRO-1 moments within 1e-4 of each leaf's largest magnitude; a
    microbatched step (accum_steps=2) too;
  · (the MoE models' token groups are in test_torch_shard_moe.py)
  · against the JAX package's own sharded step on 4 host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in a
    subprocess, as tests/test_sim_shard.py runs it), placed by
    ``param_pspecs``/``moments_pspecs``/``batch_pspecs`` as
    launch/dryrun.py places it: reduced arctic-480b (G = 4) and
    qwen2-vl-2b on a (4, 1) mesh, 2 steps, within the limits above; each
    moment's blocks have the shapes of the reference's shards;
  · placement: row order over ('pod', 'data'), one copy per device; two
    names of the CPU as two devices (a replica and its blocks on each);
  · a sharded checkpoint writes the unsharded state's bytes, and a
    restore into a sharded state then 3 steps equals 6 straight, bit for
    bit;
  · refusals: a model axis of size 2 for the families slice 11d.5b.2
    ports, and ``launch/train.py --mesh``.  (The model axis of the dense
    and RWKV families is in test_torch_shard_tp.py.)
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro_torch.checkpointing.checkpoint import restore, save
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (jitter_constant_leaves, lm_params_to_numpy,
                                 lm_params_to_torch, seeded_lm_params)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_ctx, make_train_mesh
from repro_torch.models import factory
from repro_torch.parallelism import sharding as shd
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
SHAPE = ShapeSpec("t", 32, 4, "train")
DATA_SEED = 5
METRIC_RTOL = 1e-5
GNORM_RTOL = 1e-4
PARAM_TOL = 1e-4          # of each leaf's largest magnitude
MESHES = [(2, 1), (4, 1), (2, 2, 1)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(cfg):
    return jitter_constant_leaves(seeded_lm_params(cfg, 0, max_seq=64), 1)


def cpu_ctx(shape):
    return make_ctx(make_train_mesh(shape, device="cpu"))


def run(cfg, tree, ctx, shape, n_steps, start=0, accum=1, state=None):
    """(per-step metrics as floats, state) of n_steps port steps."""
    opt_cfg = OptConfig(**KW)
    kw = {} if ctx is None else {"ctx": ctx}
    if state is None:
        model = factory.from_state_dict(cfg, lm_params_to_torch(tree, cfg,
                                                                "cpu"))
        state = TS.init_train_state(model, cfg, opt_cfg, **kw)
    step_fn = TS.make_train_step(cfg, opt_cfg, accum_steps=accum, **kw)
    rows = []
    for step in range(start, start + n_steps):
        batch = to_device(make_batch_np(cfg, shape, DATA_SEED, step), "cpu")
        state, m = step_fn(state, batch)
        rows.append({k: float(x) for k, x in m.items()})
    return rows, state


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_err(got: dict, want: dict) -> tuple:
    """(worst max |g - w| / max |w| over the leaves, its leaf)."""
    worst = (0.0, "")
    for n, w in want.items():
        w = torch.as_tensor(np.asarray(w)).double()
        g = torch.as_tensor(np.asarray(got[n])).double()
        e = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
        worst = max(worst, (e, n))
    return worst


def assert_rows_close(rows, want_rows, aux=False):
    keys = ("loss", "ce") + (("aux",) if aux else ())
    for r, w in zip(rows, want_rows):
        for k in keys:
            assert rel(r[k], w[k]) <= METRIC_RTOL, (k, r[k], w[k])
        assert rel(r["grad_norm"], w["grad_norm"]) <= GNORM_RTOL, (r, w)


def params_of(state) -> dict:
    return {k: v.detach().clone()
            for k, v in state["params"].state_dict().items()}


_PLAIN = {}


def plain_run(arch, accum=1):
    """The port's unsharded 3 steps of ``arch``, once per module."""
    if (arch, accum) not in _PLAIN:
        cfg = get_reduced(arch)
        rows, state = run(cfg, weights(cfg), None, SHAPE, 3, accum=accum)
        _PLAIN[arch, accum] = rows, params_of(state), {
            k: {n: t.clone() for n, t in state["opt"][k].items()}
            for k in ("m", "v")}
    return _PLAIN[arch, accum]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "minitron-8b",
                                  "rwkv6-1.6b", "whisper-base"])
def test_dp_step_matches_unsharded(arch, mesh):
    cfg = get_reduced(arch)
    want_rows, want_params, want_opt = plain_run(arch)
    ctx = cpu_ctx(mesh)
    rows, state = run(cfg, weights(cfg), ctx, SHAPE, 3)
    assert state["step"] == 3
    assert_rows_close(rows, want_rows)
    err, leaf = leaf_err(params_of(state), want_params)
    assert err <= PARAM_TOL, (leaf, err)
    # ZeRO-1: the gathered moments equal the unsharded step's
    plain = TS.plain_state(state)
    for k in ("m", "v"):
        err, leaf = leaf_err(plain["opt"][k], want_opt[k])
        assert err <= PARAM_TOL, (k, leaf, err)
    # and the step moved the weights well past that limit
    init = factory.from_state_dict(cfg, lm_params_to_torch(
        weights(cfg), cfg, "cpu")).state_dict()
    assert leaf_err(params_of(state), init)[0] > 10 * PARAM_TOL


def test_dp_step_with_microbatches_matches_unsharded():
    arch = "minitron-8b"
    cfg = get_reduced(arch)
    want_rows, want_params, _ = plain_run(arch, accum=2)
    rows, state = run(cfg, weights(cfg), cpu_ctx((2, 1)), SHAPE, 3,
                      accum=2)
    assert_rows_close(rows, want_rows)
    err, leaf = leaf_err(params_of(state), want_params)
    assert err <= PARAM_TOL, (leaf, err)


# ---------------------------------------------------------------------------
# against the JAX package's sharded step on 4 host devices
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_reduced
    from repro.launch.mesh import make_ctx
    from repro.parallelism import sharding as shd
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import make_train_step
    from repro_torch.convert import (jitter_constant_leaves,
                                     seeded_lm_params)
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import make_batch_np

    arch, out, kw, shape, seed, n, mesh_shape = json.loads(sys.argv[1])
    cfg = get_reduced(arch)
    mesh = Mesh(np.asarray(jax.devices()).reshape(mesh_shape),
                ("data", "model"))
    ctx = make_ctx(mesh)
    opt = OptConfig(**kw)
    params = jax.tree_util.tree_map(jnp.asarray, jitter_constant_leaves(
        seeded_lm_params(cfg, 0, max_seq=64), 1))
    state = {"params": params, "opt": init_opt_state(params, opt),
             "step": jnp.zeros((), jnp.int32)}
    pspecs = shd.param_pspecs(params, cfg, ctx)
    mspecs = shd.moments_pspecs(pspecs, params, ctx)
    state_specs = {"params": pspecs, "opt": {"m": mspecs, "v": mspecs},
                   "step": P()}
    b, s = shape
    first = make_batch_np(cfg, ShapeSpec("t", s, b, "train"), seed, 0)
    batch_specs = shd.batch_pspecs(first, ctx)
    metric_specs = {k: P() for k in ("loss", "ce", "aux", "grad_norm")}
    named = lambda t: shd.named(mesh, t)
    step = jax.jit(make_train_step(cfg, opt, ctx),
                   in_shardings=(named(state_specs), named(batch_specs)),
                   out_shardings=(named(state_specs), named(metric_specs)))
    state = jax.device_put(state, named(state_specs))
    rows = []
    for i in range(n):
        batch = make_batch_np(cfg, ShapeSpec("t", s, b, "train"), seed, i)
        state, m = step(state, jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, batch), named(batch_specs)))
        rows.append({k: float(v) for k, v in m.items()})
    flat = {}
    shards = {}
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    for path, x in jax.tree_util.tree_leaves_with_path(state["params"]):
        flat["/".join(shd._path_names(path))] = np.asarray(x)
    for path, x in jax.tree_util.tree_leaves_with_path(state["opt"]["m"]):
        key = "/".join(shd._path_names(path))
        by_dev = sorted((order[sh.device], list(sh.data.shape))
                        for sh in x.addressable_shards)
        shards[key] = [shp for _, shp in by_dev]
    np.savez(out, **flat)
    print(json.dumps({"rows": rows, "shards": shards}))
""")


def ref_names(name: str) -> str:
    return "/".join(shd._ref_path(name)[0])


def check_against_reference(arch, mesh, tmp_path):
    """The port's 2 steps of reduced ``arch`` on a CPU mesh of ``mesh``
    (('data', 'model')) against the JAX package's sharded step on a host
    mesh of that shape: metrics, parameters and each position's moment
    block shapes."""
    cfg = get_reduced(arch)
    out = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps([arch, out, KW, [4, 32], DATA_SEED, 2, list(mesh)])
    proc = subprocess.run([sys.executable, "-c", SCRIPT, arg], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    want = dict(np.load(out))
    rows, state = run(cfg, weights(cfg), cpu_ctx(mesh), SHAPE, 2)
    assert_rows_close(rows, ref["rows"], aux=cfg.moe is not None)
    if cfg.moe is not None:
        assert all(r["aux"] > 0 for r in ref["rows"])
    # the port's layers against the reference's stacked leaves
    got = lm_params_to_numpy(params_of(state), cfg)
    flat = {"/".join(shd._ref_path(n)[0]): None for n in params_of(state)}
    got_flat = {}
    for (path, x) in jax.tree_util.tree_leaves_with_path(got):
        got_flat["/".join(
            str(k.key) if hasattr(k, "key") else f"[{k.idx}]"
            for k in path)] = x
    assert set(got_flat) == set(want) == set(flat)
    err, leaf = leaf_err(got_flat, want)
    assert err <= PARAM_TOL, (leaf, err)
    # ZeRO-1: each position's moment blocks have the reference's shard
    # shapes (a stacked leaf's layers counted on its layer axis)
    layers = shd.leaf_layers(state["opt"]["m"])
    held: dict = {}
    for name, sh in state["opt"]["m"].items():
        key = ref_names(name)
        for p, blk in enumerate(sh.blocks):
            entry = held.setdefault(key, [[0, None] for _ in sh.blocks])
            if blk is None:
                continue
            entry[p][0] += 1
            entry[p][1] = list(blk.shape)
        assert sh.spec == state["specs"][name]
    for key, per_pos in held.items():
        stacked = any(layers[n] is not None for n in state["opt"]["m"]
                      if ref_names(n) == key)
        shapes = [([c] + s if stacked else s) for c, s in per_pos]
        assert shapes == ref["shards"][key], (key, shapes,
                                              ref["shards"][key])


@pytest.mark.parametrize("arch", ["arctic-480b", "qwen2-vl-2b"])
def test_matches_the_reference_sharded_step(arch, tmp_path):
    check_against_reference(arch, (4, 1), tmp_path)


# ---------------------------------------------------------------------------
# placement, checkpoints, refusals
# ---------------------------------------------------------------------------

def test_rows_follow_the_reference_order_and_repeat_no_storage():
    mesh = make_train_mesh((2, 2, 1), device="cpu")
    ctx = make_ctx(mesh)
    x = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
    sh = shd.shard_tree(x, shd.batch_pspecs(x, ctx), mesh)["tokens"]
    # position (pod, data) holds rows of block pod * 2 + data, row-major
    for p, blk in enumerate(sh.blocks):
        assert torch.equal(blk, x["tokens"][2 * p:2 * p + 2])
        assert blk.untyped_storage().data_ptr() == \
            x["tokens"].untyped_storage().data_ptr()
    cfg = get_reduced("arctic-480b")
    state = TS.init_train_state(0, cfg, OptConfig(**KW), device="cpu",
                                ctx=ctx)
    n_moment = sum(p.numel() for p in state["params"].parameters())
    stored = sum(t.numel() for sh in state["opt"]["m"].values()
                 for items in sh.stores.values() for _, t in items)
    assert stored == n_moment                 # every block stored once
    specs = state["specs"]
    assert specs["groups.0.0.moe.wi_gate"] == (None, ("pod", "data"), None,
                                               "model")
    assert list(state["replicas"]) == [torch.device("cpu")]


@pytest.mark.parametrize("arch,shape", [
    pytest.param("minitron-8b", (4, 1), id="minitron-8b"),
    pytest.param("arctic-480b", (4, 1), id="arctic-480b"),
    pytest.param("minitron-8b", (1, 2), id="minitron-8b-model-axis")])
def test_distinct_devices_hold_their_blocks(arch, shape):
    """Two names of the CPU ("cpu", "cpu:0") stand for two devices.  On a
    (4, 1) mesh each holds a replica of the model and its positions'
    moment blocks only; on a (1, 2) mesh each stores only its block of
    each parameter the model axis splits (and of its moments), and the
    whole of a replicated one.  Gradients meet on the first, blocks are
    copied across, and the run equals one on a single repeated device
    within the limits above."""
    cfg = get_reduced(arch)
    cpu0 = torch.device("cpu", 0)
    n = shape[0] * shape[1]
    devs = ["cpu"] * (n // 2) + [cpu0] * (n // 2)
    if shape[1] > 1:
        devs = ["cpu", cpu0]
    ctx = make_ctx(make_train_mesh(shape, devices=devs))
    want_rows, want = run(cfg, weights(cfg), cpu_ctx(shape), SHAPE, 3)
    rows, state = run(cfg, weights(cfg), ctx, SHAPE, 3)
    assert_rows_close(rows, want_rows, aux=cfg.moe is not None)
    got_params = TS.plain_state(state)["params"].state_dict()
    err, leaf = leaf_err(got_params, params_of(want))
    assert err <= PARAM_TOL, (leaf, err)
    placed = state["placed"]
    if shape[1] == 1:
        assert list(state["replicas"]) == [torch.device("cpu"), cpu0]
        other = state["replicas"][cpu0].state_dict()
        for k, v in state["params"].state_dict().items():
            assert torch.equal(v, other[k]) and \
                v.data_ptr() != other[k].data_ptr(), k
    else:
        assert state["params"] is None and not state["replicas"]
        split = 0
        for name, sh in placed.items():
            ptrs = {t.data_ptr() for items in sh.stores.values()
                    for _, t in items}
            assert len(ptrs) == 2, name               # one store each
            if "model" not in sh.spec:
                assert all(dev in sh.wholes for dev in sh.stores), name
                continue
            split += 1
            assert not sh.wholes, name
            for p, dev in enumerate(ctx.mesh.devices.flat):
                (blk, t), = sh.stores[dev]
                assert blk == sh.where[p] and t is sh.blocks[p]
                assert t.numel() * 2 == got_params[name].numel(), name
                assert torch.equal(t, got_params[name][shd.index_of(blk)])
        assert split > 0
    partial = 0                 # moments that no one device holds whole
    for name, sh in state["opt"]["m"].items():
        partial += any(dev not in sh.wholes for dev in sh.stores)
        for dev, items in sh.stores.items():
            held = {sh.blocks[p].data_ptr() for p in range(n)
                    if ctx.mesh.devices.flat[p] == dev
                    and sh.blocks[p] is not None}
            assert {t.data_ptr() for _, t in items} == held, name
    assert partial > 0
    got, ref = TS.plain_state(state), TS.plain_state(want)
    for k in ("m", "v"):
        err, leaf = leaf_err(got["opt"][k], ref["opt"][k])
        assert err <= PARAM_TOL, (k, leaf, err)


def test_sharded_checkpoint_is_the_unsharded_file_and_restarts(tmp_path):
    arch = "arctic-480b"
    cfg = get_reduced(arch)
    tree = weights(cfg)
    shape = ShapeSpec("t", 32, 2, "train")
    ctx = cpu_ctx((2, 1))
    _, straight = run(cfg, tree, ctx, shape, 6)
    _, state = run(cfg, tree, ctx, shape, 3)
    save(str(tmp_path / "sharded"), 3, state, cfg)
    # the same values in an unsharded state
    plain = TS.plain_state(state)
    model = factory.from_state_dict(cfg, {k: v.detach().clone() for k, v in
                                          state["params"].state_dict().items()})
    flat = TS.init_train_state(model, cfg, OptConfig(**KW))
    for k in ("m", "v"):
        for n, t in plain["opt"][k].items():
            flat["opt"][k][n].copy_(t)
    flat["step"] = 3
    save(str(tmp_path / "flat"), 3, flat, cfg)
    names = ("sharded", "flat")
    a, b = (open(tmp_path / d / "step-00000003.npz", "rb").read()
            for d in names)
    assert a == b
    # restore into other weights, sharded, and 3 more steps
    other = jitter_constant_leaves(seeded_lm_params(cfg, 9, max_seq=64), 2)
    _, fresh = run(cfg, other, ctx, shape, 0)
    restore(str(tmp_path / "sharded"), 3, fresh, cfg)
    assert fresh["step"] == 3
    _, resumed = run(cfg, other, ctx, shape, 3, start=3, state=fresh)
    for k, v in straight["params"].state_dict().items():
        assert torch.equal(resumed["params"].state_dict()[k], v), k
    for k in ("m", "v"):
        want = TS.plain_state(straight)["opt"][k]
        for n, t in TS.plain_state(resumed)["opt"][k].items():
            assert torch.equal(t, want[n]), (k, n)


def test_a_model_axis_refuses():
    """A model axis of 2 trains the dense and RWKV families
    (test_torch_shard_tp.py); for the MoE layers, MLA, jamba's period,
    Whisper and a head_dim split it raises, naming slice 11d.5b.2."""
    ctx = make_ctx(make_train_mesh((2, 2), device="cpu"))
    assert ctx.tp_size == 2
    TS.make_train_step(get_reduced("minitron-8b"), OptConfig(), ctx)
    for arch in ("arctic-480b", "jamba-v0.1-52b", "deepseek-v3-671b",
                 "whisper-base"):
        cfg = get_reduced(arch)
        with pytest.raises(NotImplementedError, match="11d.5b.2"):
            TS.make_train_step(cfg, OptConfig(), ctx)
        with pytest.raises(NotImplementedError, match="11d.5b.2"):
            TS.init_train_state(0, cfg, OptConfig(), device="cpu", ctx=ctx)
    # 6 heads of 16 on a model axis of 4: the reference splits head_dim
    with pytest.raises(NotImplementedError, match="head_dim.*11d.5b.2"):
        TS.make_train_step(get_reduced("qwen2-vl-2b"), OptConfig(),
                           make_ctx(make_train_mesh((1, 4), device="cpu")))
    # a sharded state and an unsharded step (or the reverse) do not mix
    cfg = get_reduced("minitron-8b")
    ctx = cpu_ctx((2, 1))
    state = TS.init_train_state(0, cfg, OptConfig(), device="cpu", ctx=ctx)
    batch = to_device(make_batch_np(cfg, SHAPE, DATA_SEED, 0), "cpu")
    with pytest.raises(ValueError, match="ctx"):
        TS.make_train_step(cfg, OptConfig())(state, batch)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_launcher_mesh_names_the_model_axis(mesh):
    with pytest.raises(NotImplementedError) as err:
        train_launcher.main(["--arch", "minitron-8b", "--device", "cpu",
                             "--steps", "1", "--mesh", mesh])
    msg = str(err.value)
    assert "data axes are ported" in msg and "11d.5b.2" in msg
    assert "model axis of 16" in msg and "splits heads" in msg
