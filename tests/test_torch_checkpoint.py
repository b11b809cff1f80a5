"""Checkpoints and restarts of the port's training (``repro_torch.
checkpointing``, ``launch/train.py``), in the JAX package's file format:

  · restart is bit-identical: 6 steps straight equal 3 steps, a save, a
    restore into other weights, and 3 more (the reference's
    tests/test_checkpoint.py contract), for moments in f32 and bf16;
  · a checkpoint that the JAX package wrote resumes in the port: 3
    reference steps, its save, then 3 port steps from it, against the
    reference's 6 straight (metrics within 1e-4 relative, parameters in
    units of lr as test_torch_train.py holds them); and the port's
    checkpoint restores in the JAX package, leaf for leaf exact;
  · ``AsyncSaver``; ``latest_step``;
  · the launcher: 4 steps with a checkpoint every 2, then a resume to 6,
    bit-identical to 6 straight; ``--mesh single`` restores that
    checkpoint into the production mesh's sharded state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as JC
from repro.configs import ShapeSpec as JShapeSpec
from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch_np as jmake_batch_np
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.checkpointing.checkpoint import (AsyncSaver, latest_step,
                                                  restore, save)
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (lm_params_to_torch, seeded_lm_params,
                                 train_state_to_numpy)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          plain_state)
from test_torch_train import assert_params_close

ARCH = "minitron-8b"
SHAPE = ShapeSpec("t", 32, 2, "train")
KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh(cfg, opt_cfg, seed):
    tree = seeded_lm_params(cfg, seed)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))
    return init_train_state(model, cfg, opt_cfg)


def train(cfg, state, step_fn, start, n):
    metrics = []
    for step in range(start, start + n):
        batch = to_device(make_batch_np(cfg, SHAPE, 7, step), "cpu")
        state, m = step_fn(state, batch)
        metrics.append({k: float(x) for k, x in m.items()})
    return state, metrics


def assert_states_equal(a, b, cfg):
    ta, tb = train_state_to_numpy(a, cfg), train_state_to_numpy(b, cfg)
    la = jax.tree_util.tree_leaves_with_path(ta)
    lb = jax.tree_util.tree_leaves_with_path(tb)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(x, y), jax.tree_util.keystr(path)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_restart_bit_identical(tmp_path, moment_dtype):
    cfg = get_reduced(ARCH)
    opt_cfg = OptConfig(**KW, moment_dtype=moment_dtype)
    step_fn = make_train_step(cfg, opt_cfg)
    straight, _ = train(cfg, fresh(cfg, opt_cfg, 0), step_fn, 0, 6)
    s1, _ = train(cfg, fresh(cfg, opt_cfg, 0), step_fn, 0, 3)
    save(str(tmp_path), 3, s1, cfg)
    del s1                                     # "crash"
    assert latest_step(str(tmp_path)) == 3
    s2 = restore(str(tmp_path), 3, fresh(cfg, opt_cfg, 1), cfg)
    assert s2["step"] == 3
    resumed, _ = train(cfg, s2, step_fn, 3, 3)
    assert_states_equal(straight, resumed, cfg)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = seeded_lm_params(cfg, 0)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**KW)))
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree),
              "opt": {k: jax.tree_util.tree_map(jnp.zeros_like, tree)
                      for k in ("m", "v")},
              "step": jnp.zeros((), jnp.int32)}
    jmetrics = []
    for step in range(6):
        batch = jmake_batch_np(jcfg, JShapeSpec("t", 32, 2, "train"), 7,
                               step)
        jstate, m = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        jmetrics.append({k: float(x) for k, x in m.items()})
        if step == 2:
            JC.save(str(tmp_path / "ref"), 3, jstate)
    opt_cfg = OptConfig(**KW)
    state = restore(str(tmp_path / "ref"), 3, fresh(cfg, opt_cfg, 1), cfg)
    state, metrics = train(cfg, state, make_train_step(cfg, opt_cfg), 3, 3)
    for m, jm in zip(metrics, jmetrics[3:]):
        for k in ("loss", "ce", "grad_norm"):
            assert abs(m[k] / jm[k] - 1) <= 1e-4, (k, m[k], jm[k])
    assert_params_close(
        jax.tree_util.tree_leaves_with_path(
            train_state_to_numpy(state, cfg)["params"]),
        jax.tree_util.tree_leaves_with_path(jstate["params"]),
        KW["peak_lr"], 3)
    # and the port's checkpoint restores in the JAX package, exactly
    save(str(tmp_path / "port"), 6, state, cfg)
    back = JC.restore(str(tmp_path / "port"), 6, jstate)
    want = train_state_to_numpy(state, cfg)
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(want)):
        assert np.array_equal(np.asarray(x), y), jax.tree_util.keystr(path)


def test_async_saver(tmp_path):
    cfg = get_reduced("rwkv6-1.6b")
    opt_cfg = OptConfig(**KW)
    state = fresh(cfg, opt_cfg, 0)
    state, _ = train(cfg, state, make_train_step(cfg, opt_cfg), 0, 2)
    saver = AsyncSaver()
    saver.save_async(str(tmp_path), 2, state, cfg)
    saver.wait()
    assert latest_step(str(tmp_path)) == 2
    got = restore(str(tmp_path), 2, fresh(cfg, opt_cfg, 1), cfg)
    assert_states_equal(state, got, cfg)


def test_launcher_resumes_bit_identical(tmp_path, capsys):
    argv = ["--arch", ARCH, "--batch", "2", "--seq", "32", "--device",
            "cpu", "--ckpt-every", "2"]
    straight = train_launcher.main(argv + ["--steps", "6"])
    train_launcher.main(argv + ["--steps", "4", "--ckpt", str(tmp_path)])
    assert latest_step(str(tmp_path)) == 4
    capsys.readouterr()
    resumed = train_launcher.main(argv + ["--steps", "6", "--ckpt",
                                          str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "[train] step=5 loss=" in out
    assert "[train] done: 2 steps, final loss" in out
    assert resumed["step"] == straight["step"] == 6
    assert_states_equal(straight, resumed, get_reduced(ARCH))
    again = train_launcher.main(argv + ["--steps", "6", "--ckpt",
                                        str(tmp_path)])
    assert again["step"] == 6
    assert "done: 0 steps, no step left" in capsys.readouterr().out
    # the same checkpoint restored through the production mesh's sharded
    # state (every position on the CPU): nothing left to take, the state
    # the straight run's
    sharded = train_launcher.main(argv + ["--steps", "6", "--ckpt",
                                          str(tmp_path), "--mesh", "single"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done: 0 steps" in out
    assert sharded["ctx"].mesh.devices.shape == (16, 16)
    assert_states_equal(straight, plain_state(sharded), get_reduced(ARCH))
