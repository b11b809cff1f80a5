"""bf16 training of the port against the JAX package's, on reduced configs
of every family with the same seeded weights
(``repro_torch.convert.seeded_lm_params``) and batches (``make_batch_np``),
numpy on both sides.

In bf16 the reference is itself far from its own f32 result (a leaf of
jamba's gradient moves by its whole magnitude), so the two packages'
bf16 results are not held to each other element by element.  The
witness rule holds the port's bf16 result against the JAX package's f32
result, the truth, at no more than WITNESS_K times the JAX package's own
bf16 distance from it:

  · ``train_loss`` and its gradients for rwkv6-1.6b (rwkv), minitron-8b
    (std:dense), arctic-480b (std:moe), deepseek-v3-671b (mla),
    whisper-base (the encoder-decoder) and qwen2-vl-2b (a batch of
    ``embeds``), and jamba-v0.1-52b (period) in
    tests/test_torch_bf16_train_period.py: the loss, the worst leaf and
    the median leaf, each leaf's distance max |g - w| / max |w|;
  · two steps of ``make_train_step`` for minitron-8b, its parameters and
    batch in bf16 (the moments f32 on both sides): loss and grad_norm at
    each step;
  · ``attention_backward_plain`` on bf16 inputs, the CPU path of the
    attention backward, against autograd of ``attention_plain`` in f64
    within BF16_TOL of each gradient's largest magnitude.

On the CPU the port's attention is ``attention_plain`` and its backward
autograd's; on the card both are kernels (tests/test_torch_cuda.py and
chip_smoke.py phases k, x, z and u hold them)."""
from functools import lru_cache

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
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_plain, attention_plain)
from repro_torch.models import factory as PF
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

# Measured on these cases (port's distance over the JAX package's own
# bf16 distance from its f32 result): loss 0.27-1.87 (jamba-v0.1-52b the
# highest), worst leaf 0.51-1.06, median leaf 0.82-1.53 (jamba again)
WITNESS_K = 2
BF16_TOL = 2e-2              # tests/test_kernels.py's bf16 tolerance
# jamba-v0.1-52b (the period kind) is held in
# tests/test_torch_bf16_train_period.py, a file of its own: its two JAX
# traces take ~35 s of the ~45 s it needs, and a file runs on one worker
ARCHS = ("rwkv6-1.6b", "minitron-8b", "arctic-480b", "deepseek-v3-671b",
         "whisper-base", "qwen2-vl-2b")
SHAPE = ShapeSpec("t", 32, 2, "train")
DATA_SEED = 3
MAX_SEQ = 64                 # Whisper's learned decoder positions
STEP_KW = dict(peak_lr=1e-2, warmup_steps=1, total_steps=8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cast(tree, dtype):
    """A numpy tree or batch with its float leaves in ``dtype``."""
    def cast(x):
        x = np.asarray(x)
        return jnp.asarray(x, dtype if np.issubdtype(x.dtype, np.floating)
                           else x.dtype)
    return jax.tree_util.tree_map(cast, tree)


def _port_batch(batch):
    return {k: v.bfloat16() if v.is_floating_point() else v
            for k, v in to_device(batch, "cpu").items()}


def _port_model(cfg, tree):
    return PF.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu")).to(
        torch.bfloat16)


def _numpy_leaves(tree):
    return [np.asarray(x, np.float32)
            for _, x in jax.tree_util.tree_leaves_with_path(tree)]


@lru_cache(maxsize=None)
def _case(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    return cfg, jcfg, seeded_lm_params(cfg, 0, max_seq=MAX_SEQ), \
        make_batch_np(cfg, SHAPE, DATA_SEED, 0)


def _jax_loss_grads(arch, dtype):
    _, jcfg, tree, batch = _case(arch)
    b = _jax_cast(batch, dtype)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JF.train_loss(p, b, cfg=jcfg), has_aux=True))(
        _jax_cast(tree, dtype))
    return float(loss), _numpy_leaves(grads)


def _distances(got, want):
    """(worst, median) over leaves of max |g - w| / max |w|."""
    d = [np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
         for g, w in zip(got, want)]
    return max(d), float(np.median(d))


def _within_witness(port, ref, truth):
    return abs(port - truth) <= WITNESS_K * abs(ref - truth)


def check_loss_and_grads(arch):
    """train_loss and its gradients in bf16, port and JAX package, against
    the JAX package's f32: the loss, the worst and the median leaf within
    the witness, every gradient bf16 and finite."""
    cfg, _, tree, batch = _case(arch)
    if cfg.frontend == "vision":
        assert "embeds" in batch
    l32, g32 = _jax_loss_grads(arch, jnp.float32)
    l16, g16 = _jax_loss_grads(arch, jnp.bfloat16)
    model = _port_model(cfg, tree).requires_grad_(True)
    loss, _ = PF.train_loss(model, _port_batch(batch), cfg=cfg)
    assert loss.dtype == torch.float32
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
               for g in grads.values())
    got = _numpy_leaves(lm_params_to_numpy(grads, cfg))
    assert len(got) == len(g32)
    assert _within_witness(loss.item(), l16, l32), (loss.item(), l16, l32)
    port, ref = _distances(got, g32), _distances(g16, g32)
    assert port[0] <= WITNESS_K * ref[0], ("worst leaf", port, ref)
    assert port[1] <= WITNESS_K * ref[1], ("median leaf", port, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_within_the_witness(arch):
    check_loss_and_grads(arch)


def test_bf16_train_steps_within_the_witness():
    """Two steps of make_train_step for minitron-8b in bf16 (parameters
    and batch), the JAX package's in bf16 and in f32 beside it: loss and
    grad_norm of each step within the witness."""
    arch = "minitron-8b"
    cfg, jcfg, tree, _ = _case(arch)
    rows = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        params = _jax_cast(tree, dt)
        state = {"params": params,
                 "opt": {k: jax.tree_util.tree_map(
                     lambda p: jnp.zeros(p.shape, jnp.float32), params)
                     for k in ("m", "v")},
                 "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(jmake_train_step(jcfg, JOptConfig(**STEP_KW)))
        rows[name] = []
        for i in range(2):
            batch = make_batch_np(cfg, SHAPE, DATA_SEED, i)
            state, m = step(state, _jax_cast(batch, dt))
            rows[name].append({k: float(m[k]) for k in ("loss",
                                                        "grad_norm")})
    opt_cfg = OptConfig(**STEP_KW)
    state = init_train_state(_port_model(cfg, tree), cfg, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    for i in range(2):
        state, m = step_fn(state, _port_batch(
            make_batch_np(cfg, SHAPE, DATA_SEED, i)))
        assert all(p.dtype == torch.bfloat16
                   for p in state["params"].parameters())
        for k in ("loss", "grad_norm"):
            got, ref, truth = (float(m[k]), rows["bf16"][i][k],
                               rows["f32"][i][k])
            assert np.isfinite(got)
            assert _within_witness(got, ref, truth), (i, k, got, ref, truth)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_plain_bf16_against_f64(causal):
    """The plain backward on bf16 inputs (GQA 6 over 2, Sq < Sk) returns
    bf16 gradients within BF16_TOL of autograd of attention_plain in f64
    on the same values."""
    rng = np.random.default_rng(31)
    b, sq, sk, h, kv, hd = 2, 24, 40, 6, 2, 32
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   .bfloat16() for s in ((b, sq, h, hd), (b, sk, kv, hd),
                                         (b, sk, kv, hd), (b, sq, h, hd)))
    got = attention_backward_plain(q, k, v, do, causal=causal)
    x64 = [x.double().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_plain(*x64, causal=causal), x64,
                               do.double())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = float((g.double() - w).abs().max() / w.abs().max())
        assert err <= BF16_TOL, err
