"""Shared by tests/test_torch_jamba_lm.py and tests/test_torch_whisper.py:
the reduced jamba-v0.1-52b and whisper-base with seeded weights
(``repro_torch.convert.seeded_lm_params``, the constant leaves jittered
by ``jitter_constant_leaves``), seeded prompts (and Whisper's frames),
the JAX package's results on them, and the golden file
tests/golden/torch_port_hybrid_reduced.json that holds those results for
the card (``chip_smoke.py`` phases j and y, which have no JAX).

Regenerate the golden file from the JAX package with
    PYTHONPATH=src python scripts/hybrid_golden.py
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.factory as JF
from repro.configs import get_reduced as jget_reduced
import repro_torch.models.factory as PF
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (jitter_constant_leaves, lm_params_to_torch,
                                 params_fingerprint, seeded_lm_params)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.models.whisper import ENC_LEN

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_port_hybrid_reduced.json")
ARCHS = ("jamba-v0.1-52b", "whisper-base")
WEIGHT_SEED, JITTER_SEED, PROMPT_SEED, FRAMES_SEED = 0, 1, 2, 4
BATCH, PROMPT_LEN, MAX_NEW = 2, 24, 6
MAX_LEN = PROMPT_LEN + MAX_NEW
MAX_SEQ = 64                 # Whisper's learned decoder positions
TOL = dict(rtol=1e-4, atol=1e-4)
MIN_MARGIN = 1e-3
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
TRAIN_SHAPE = ShapeSpec("t", 32, 2, "train")
DATA_SEED = 3


def weights(cfg):
    return jitter_constant_leaves(
        seeded_lm_params(cfg, WEIGHT_SEED, max_seq=MAX_SEQ), JITTER_SEED)


def prompt(cfg):
    rng = np.random.default_rng(PROMPT_SEED)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)


def frames(cfg, batch=BATCH):
    """Whisper's seeded frame embeddings (batch, ENC_LEN, d_model) f32."""
    return np.random.default_rng(FRAMES_SEED).standard_normal(
        (batch, ENC_LEN, cfg.d_model), dtype=np.float32)


def serve_batch(cfg, toks):
    """The prefill's numpy batch: tokens, and frames for Whisper."""
    if cfg.enc_dec:
        return {"frames": frames(cfg, toks.shape[0]), "tokens": toks}
    return {"tokens": toks}


def to_port(batch, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def top2_margin(logits) -> float:
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


def jax_reference(tree, jcfg, batch):
    """Prefill logits and cache (max_len = prompt + MAX_NEW), the first
    decode step's logits, the greedy tokens and the least top-2 margin
    along the greedy path."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    logits, cache = jax.jit(lambda p, b: JF.prefill(
        p, b, cfg=jcfg, max_len=MAX_LEN))(params, jbatch)
    step = jax.jit(lambda p, c, t: JF.decode(p, c, {"tokens": t}, cfg=jcfg))
    margins = [top2_margin(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out, step_cache, dec_logits = [tok], cache, None
    for i in range(MAX_NEW - 1):
        lg, step_cache = step(params, step_cache, tok)
        dec_logits = lg if i == 0 else dec_logits
        margins.append(top2_margin(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        out.append(tok)
    return {"prefill_logits": np.asarray(logits),
            "cache": jax.tree_util.tree_map(np.asarray, cache),
            "decode_logits": np.asarray(dec_logits),
            "tokens": np.asarray(jnp.concatenate(out, 1)),
            "min_margin": min(margins)}


@functools.cache
def case(arch):
    """(cfg, tree, prompt tokens, port model on the CPU, JAX reference),
    once per arch and process."""
    cfg = get_reduced(arch)
    tree, toks = weights(cfg), prompt(cfg)
    model = PF.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))
    return (cfg, tree, toks, model,
            jax_reference(tree, jget_reduced(arch), serve_batch(cfg, toks)))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), **tol)


def port_greedy(model, cfg, batch):
    """The port's greedy tokens through factory.prefill and decode (the
    reference's generate takes token prompts only)."""
    logits, cache = PF.prefill(model, batch, cfg=cfg, max_len=MAX_LEN)
    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    for _ in range(MAX_NEW - 1):
        logits, cache = PF.decode(model, cache, {"tokens": toks[-1]},
                                  cfg=cfg)
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return torch.cat(toks, 1)


def jax_grads(tree, jcfg, batch):
    """(loss, metrics, gradient tree) of the JAX package's train_loss."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JF.train_loss(p, b, cfg=jcfg), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, batch))
    return float(loss), metrics, grads


def check_golden(arch):
    """The golden file is the JAX package's result for this arch, and the
    port on the CPU meets it (the training loss of its batch too)."""
    cfg, tree, toks, model, ref = case(arch)
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert (golden["weight_seed"], golden["jitter_seed"], golden["max_new"],
            golden["max_len"], golden["max_seq"], golden["frames_seed"]) == (
        WEIGHT_SEED, JITTER_SEED, MAX_NEW, MAX_LEN, MAX_SEQ, FRAMES_SEED)
    g = golden["archs"][arch]
    assert g["weights_sum"] == pytest.approx(params_fingerprint(tree),
                                             rel=1e-9)
    assert np.array_equal(np.asarray(golden["prompt"][arch], np.int32), toks)
    for key in ("prefill_logits", "decode_logits"):
        close(np.asarray(g[key], np.float32), ref[key])
    assert np.array_equal(np.asarray(g["tokens"]), ref["tokens"])
    logits, _ = PF.prefill(model, to_port(serve_batch(cfg, toks)), cfg=cfg,
                           max_len=MAX_LEN)
    close(logits, np.asarray(g["prefill_logits"], np.float32))
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    loss, _ = PF.train_loss(model, to_device(batch, "cpu"), cfg=cfg)
    assert abs(loss.item() / g["train_loss"] - 1) <= LOSS_RTOL


def regen(path=GOLDEN):
    """Write the golden file from the JAX package."""
    golden = {"config": "reduced", "weight_seed": WEIGHT_SEED,
              "jitter_seed": JITTER_SEED, "max_new": MAX_NEW,
              "max_len": MAX_LEN, "max_seq": MAX_SEQ,
              "frames_seed": FRAMES_SEED, "data_seed": DATA_SEED,
              "train_shape": [TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len],
              "prompt": {}, "archs": {}}
    for arch in ARCHS:
        cfg, jcfg = get_reduced(arch), jget_reduced(arch)
        tree, toks = weights(cfg), prompt(cfg)
        ref = jax_reference(tree, jcfg, serve_batch(cfg, toks))
        assert ref["min_margin"] > MIN_MARGIN, (arch, ref["min_margin"])
        batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
        jloss, _ = JF.train_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jax.tree_util.tree_map(jnp.asarray, batch),
                                 cfg=jcfg)
        golden["prompt"][arch] = toks.tolist()
        golden["archs"][arch] = {
            "weights_sum": params_fingerprint(tree),
            "min_top2_margin": ref["min_margin"],
            "prefill_logits": ref["prefill_logits"].tolist(),
            "decode_logits": ref["decode_logits"].tolist(),
            "tokens": ref["tokens"].tolist(),
            "train_loss": float(jloss)}
    with open(path, "w") as f:
        json.dump(golden, f)
    print(f"wrote {path}")
