"""The port's training path (``factory.train_loss``, ``train/``) against
the JAX package's, on reduced configs with the same seeded weights
(``repro_torch.convert.seeded_lm_params``) and the same batches
(``make_batch_np``, numpy on both sides).

  · ``train_loss`` within 1e-5 relative of the reference's, and every
    gradient leaf within 1e-4 of its largest magnitude, for reduced
    rwkv6-1.6b, minitron-8b, codeqwen1.5-7b and qwen2-vl-2b (a batch of
    ``embeds``, the vision frontend's stub);
  · three steps of ``make_train_step`` (and two with ``accum_steps=2``):
    ``loss``, ``ce`` and ``grad_norm`` within 1e-4 relative at every
    step, and the parameters held in units of lr after the last
    (``assert_params_close``: AdamW divides by sqrt(v) + eps, so an
    element whose gradient is a rounding away from 0 moves by up to
    about lr a step in either package, and not bit for bit);
  · ``make_eval_step``; serving a model made trainable leaves every
    ``.grad`` None and records no autograd graph.

The gradients of the two kernels alone are in test_torch_train_kernels.py,
the optimizer's in test_torch_optimizer.py, checkpoints and the launcher
in test_torch_checkpoint.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.factory as JF
from repro.configs import get_reduced as jget_reduced
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (lm_params_to_numpy, lm_params_to_torch,
                                 seeded_lm_params)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.models import factory as PF
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (init_train_state, make_eval_step,
                                          make_train_step)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest magnitude
METRIC_RTOL = 1e-4
# parameters: all but a PARAM_SHARE of the elements within PARAM_LR_TOL
# lr of the reference's, and every element within n_steps lr
PARAM_LR_TOL = 1e-3
PARAM_SHARE = 1e-3
SHAPE = ShapeSpec("t", 32, 2, "train")
DATA_SEED = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_of(cfg, tree) -> LM:
    return LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_params_close(got, want, lr, n_steps):
    """Parameter trees (leaves with paths) after n_steps of AdamW at a
    learning rate of at most lr: every element within n_steps lr, all but
    a PARAM_SHARE of them within PARAM_LR_TOL lr."""
    far = total = 0
    for (path, g), (_, w) in zip(got, want):
        d = np.abs(g - np.asarray(w))
        assert d.max() <= n_steps * lr, jax.tree_util.keystr(path)
        far += int((d > PARAM_LR_TOL * lr).sum())
        total += d.size
    assert far <= PARAM_SHARE * total, (far, total)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minitron-8b",
                                  "codeqwen1.5-7b", "qwen2-vl-2b"])
def test_train_loss_and_grads_match_jax(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = seeded_lm_params(cfg, 0)
    batch = make_batch_np(cfg, SHAPE, DATA_SEED, 0)
    if cfg.frontend == "vision":
        assert "embeds" in batch
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JF.train_loss(p, jax.tree_util.tree_map(jnp.asarray,
                                                          batch), cfg=jcfg),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    model = model_of(cfg, tree).requires_grad_(True)
    loss, metrics = PF.train_loss(model, to_device(batch, "cpu"), cfg=cfg)
    assert abs(loss.item() / float(jloss) - 1) <= LOSS_RTOL
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), grads)}
    got = leaves(lm_params_to_numpy(grads, cfg))
    want = leaves(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path), err)


def _trajectory(arch, n_steps, accum):
    """Per-step metrics and final parameters of both packages."""
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = seeded_lm_params(cfg, 0)
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=8)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**kw),
                                     accum_steps=accum))
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree),
              "opt": {k: jax.tree_util.tree_map(jnp.zeros_like, tree)
                      for k in ("m", "v")},
              "step": jnp.zeros((), jnp.int32)}
    opt_cfg = OptConfig(**kw)
    state = init_train_state(model_of(cfg, tree), cfg, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=accum)
    rows = []
    for step in range(n_steps):
        batch = make_batch_np(cfg, SHAPE, DATA_SEED, step)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                          batch))
        state, m = step_fn(state, to_device(batch, "cpu"))
        rows.append(({k: float(m[k]) for k in ("loss", "ce", "grad_norm")},
                     {k: float(jm[k]) for k in ("loss", "ce", "grad_norm")}))
    lr = float(opt_cfg.peak_lr)       # past warmup: at most the peak
    got = lm_params_to_numpy(state["params"].state_dict(), cfg)
    return rows, leaves(got), leaves(jstate["params"]), lr, state


@pytest.mark.parametrize("n_steps,accum", [(3, 1), (2, 2)])
def test_train_steps_match_jax(n_steps, accum):
    rows, got, want, lr, state = _trajectory("minitron-8b", n_steps, accum)
    assert state["step"] == n_steps
    for m, jm in rows:
        for k in m:
            assert abs(m[k] / jm[k] - 1) <= METRIC_RTOL, (k, m[k], jm[k])
    assert_params_close(got, want, lr, n_steps)
    # the steps past warmup moved the weights by 100 times the tolerance
    init = leaves(seeded_lm_params(get_reduced("minitron-8b"), 0))
    assert max(float(np.abs(np.asarray(w) - i).max())
               for (_, w), (_, i) in zip(want, init)) > \
        100 * PARAM_LR_TOL * lr


def test_eval_step_equals_train_loss():
    cfg = get_reduced("codeqwen1.5-7b")
    model = model_of(cfg, seeded_lm_params(cfg, 1)).requires_grad_(True)
    batch = to_device(make_batch_np(cfg, SHAPE, DATA_SEED, 5), "cpu")
    metrics = make_eval_step(cfg)(model, batch)
    loss, _ = PF.train_loss(model, batch, cfg=cfg)
    assert not metrics["loss"].requires_grad
    assert metrics["loss"].item() == loss.item()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minitron-8b"])
def test_serving_a_trainable_model_records_no_graph(arch):
    cfg = get_reduced(arch)
    state = init_train_state(0, cfg, OptConfig(), device="cpu")
    model = state["params"]
    assert all(p.requires_grad for p in model.parameters())
    prompts = torch.from_numpy(make_batch_np(cfg, ShapeSpec(
        "p", 16, 2, "prefill"), DATA_SEED, 0)["tokens"])
    logits, cache = PF.prefill(model, {"tokens": prompts}, cfg=cfg,
                               max_len=20)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    step_logits, cache = PF.decode(model, cache, {"tokens": tok}, cfg=cfg)
    toks = PF.generate(model, cfg, prompts, max_new=3)
    for t in (logits, step_logits, toks, *cache["groups"][0].values()):
        assert not t.requires_grad and t.grad_fn is None
    assert all(p.grad is None for p in model.parameters())
