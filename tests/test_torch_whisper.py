"""The port's Whisper (``repro_torch.models.whisper``) against the JAX
package's ``models/whisper.py``, on the reduced whisper-base (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, LayerNorm, GELU, tied
embeddings) with the same seeded weights and frames (tests/_hybrid.py):

  · ``sinusoidal_embedding`` equal to the reference's, bit for bit;
  · the seeded tree has the leaf names and shapes of ``jax.eval_shape``
    of the JAX ``init_params``; ``init_cache`` leaves equal in shape and
    dtype;
  · ``encode`` and ``decoder_train`` within rtol/atol 1e-4; the cross
    attention of more decoder queries than encoder frames;
  · prefill logits and cache, one decode step from the JAX package's own
    cache, and the greedy tokens: logits within 1e-4, tokens equal (top-2
    margins above 1e-3 along the greedy path, asserted);
  · decode from the cache equals a teacher-forced prefill (2e-3);
  · ``train_loss`` within 1e-5 relative, every gradient leaf within 1e-4
    of its largest magnitude;
  · checkpoints: the reference's restored by the port and the port's by
    the reference, leaf for leaf exact; the async saver's round trip
    (mirroring tests/test_checkpoint.py::test_async_saver);
  · the golden file's whisper entry is the JAX package's result and the
    port meets it; ``launch/train.py`` trains whisper-base.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.factory as JF
import repro.models.whisper as JW
from repro.checkpointing import checkpoint as JC
from repro.configs import get_reduced as jget_reduced
from repro.models.layers.common import sinusoidal_embedding as jsinusoid
from repro.parallelism.ctx import NULL_CTX
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import make_train_step as jmake_train_step
import repro_torch.models.factory as PF
import repro_torch.models.whisper as PW
from _hybrid import (BATCH, DATA_SEED, GRAD_TOL, LOSS_RTOL, MAX_LEN,
                     MAX_SEQ, MIN_MARGIN, PROMPT_LEN, TRAIN_SHAPE, case,
                     check_golden, close, frames, jax_grads, port_greedy,
                     serve_batch, to_port, weights)
from repro_torch.checkpointing.checkpoint import (AsyncSaver, latest_step,
                                                  restore, save)
from repro_torch.configs import get_reduced
from repro_torch.convert import (lm_cache_to_numpy, lm_cache_to_torch,
                                 lm_params_to_numpy, lm_params_to_torch,
                                 seeded_lm_params, train_state_to_numpy)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch import train as train_launcher
from repro_torch.models.layers.common import sinusoidal_embedding
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

ARCH = "whisper-base"
KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("length,dim", [(1500, 512), (1500, 64), (7, 10)])
def test_sinusoidal_embedding_exact(length, dim):
    got = sinusoidal_embedding(length, dim)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    assert np.array_equal(got.numpy(), np.asarray(jsinusoid(length, dim)))


def test_seeded_tree_and_cache_match_jax():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    want = jax.eval_shape(lambda k: JF.init_params(k, jcfg, max_seq=MAX_SEQ),
                          jax.random.PRNGKey(0))
    got = weights(cfg)
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (a.shape, str(a.dtype)), t)
    assert shapes(got) == shapes(want)
    model = PF.init_params(0, cfg, device="cpu", max_seq=MAX_SEQ)
    assert isinstance(model, PW.Whisper)
    sd = lm_params_to_torch(got, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    back = lm_params_to_numpy(sd, cfg)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(got)):
        assert np.array_equal(a, b), jax.tree_util.keystr(p)
    wc = jax.eval_shape(lambda: JF.init_cache(jcfg, 3, 40))
    gc = lm_cache_to_numpy(PF.init_cache(cfg, 3, 40, device="cpu"))
    assert sorted(gc) == sorted(wc)
    for k, w in wc.items():
        assert gc[k].shape == w.shape and gc[k].dtype == w.dtype
        assert not gc[k].any()


def test_encode_and_decoder_train_match_jax():
    cfg, tree, toks, model, _ = case(ARCH)
    jcfg, p = jget_reduced(ARCH), jparams(tree)
    fr = frames(cfg)
    enc = PW.encode(model, torch.from_numpy(fr), cfg=cfg)
    jenc = JW.encode(p, jnp.asarray(fr), cfg=jcfg, ctx=NULL_CTX)
    close(enc, jenc)
    hid = PW.decoder_train(model, torch.from_numpy(toks), enc, cfg=cfg)
    jhid = JW.decoder_train(p, jnp.asarray(toks), jenc, cfg=jcfg,
                            ctx=NULL_CTX)
    close(hid, jhid)


def test_cross_attention_more_queries_than_frames():
    """Non-causal cross attention of 40 decoder queries over 30 encoder
    frames (Sq > Sk, which the reference allows): the flash wrapper takes
    it and matches the reference's."""
    import repro.models.layers.attention as JA
    import repro_torch.models.layers.attention as PA
    cfg, tree, *_ = case(ARCH)
    jcfg = jget_reduced(ARCH)
    cross = {k: v[0] for k, v in tree["dec_blocks"]["cross_attn"].items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((BATCH, 40, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((BATCH, 30, cfg.d_model), dtype=np.float32)
    got = PA.cross_attention_train(
        {k: torch.from_numpy(v.copy()) for k, v in cross.items()},
        torch.from_numpy(x), torch.from_numpy(enc), cfg=cfg)
    want = JA.cross_attention_train(jparams(cross), jnp.asarray(x),
                                    jnp.asarray(enc), cfg=jcfg, ctx=NULL_CTX)
    close(got, want)


def test_prefill_matches_jax():
    cfg, _, toks, model, ref = case(ARCH)
    logits, cache = PF.prefill(model, to_port(serve_batch(cfg, toks)),
                               cfg=cfg, max_len=MAX_LEN)
    assert logits.shape == (BATCH, cfg.padded_vocab(32))
    close(logits, ref["prefill_logits"])
    got, want = lm_cache_to_numpy(cache), ref["cache"]
    assert sorted(got) == sorted(want) == ["ck", "cv", "k", "len", "v"]
    assert np.array_equal(got["len"], want["len"])
    for k in ("k", "v", "ck", "cv"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        close(got[k], want[k])
    assert not got["k"][:, :, PROMPT_LEN:].any()


def test_decode_step_matches_jax():
    """One decode step from the JAX package's own cache, carried across;
    the cache given is left unchanged."""
    cfg, _, _, model, ref = case(ARCH)
    cache = lm_cache_to_torch(ref["cache"], "cpu")
    tok = torch.from_numpy(ref["tokens"][:, :1].copy())
    logits, new = PF.decode(model, cache, {"tokens": tok}, cfg=cfg)
    close(logits, ref["decode_logits"])
    assert new["len"].tolist() == [PROMPT_LEN + 1] * BATCH
    assert np.array_equal(cache["k"].numpy(), ref["cache"]["k"])
    assert new["k"][:, :, PROMPT_LEN].abs().sum() > 0


def test_greedy_tokens_match_jax():
    cfg, _, toks, model, ref = case(ARCH)
    assert ref["min_margin"] > MIN_MARGIN, ref["min_margin"]
    got = port_greedy(model, cfg, to_port(serve_batch(cfg, toks)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref["tokens"])


@pytest.mark.parametrize("s,steps", [(16, 1), (24, 8)])
def test_cache_consistency(s, steps):
    cfg, _, toks, model, _ = case(ARCH)
    fr = torch.from_numpy(frames(cfg))
    t = torch.from_numpy(toks[:, :s].copy())
    full, _ = PF.prefill(model, {"frames": fr, "tokens": t}, cfg=cfg)
    dec, cache = PF.prefill(model, {"frames": fr, "tokens":
                                    t[:, :s - steps]}, cfg=cfg, max_len=s)
    for i in range(s - steps, s):
        dec, cache = PF.decode(model, cache, {"tokens": t[:, i:i + 1]},
                               cfg=cfg)
    assert cache["len"].tolist() == [s] * BATCH
    assert float((full - dec).abs().max()) < 2e-3


def test_train_loss_and_grads_match_jax():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = weights(cfg)
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    jloss, jm, jgrads = jax_grads(tree, jcfg, batch)
    model = PF.from_state_dict(
        cfg, lm_params_to_torch(tree, cfg, "cpu")).requires_grad_(True)
    loss, metrics = PF.train_loss(model, to_device(batch, "cpu"), cfg=cfg)
    assert abs(loss.item() / jloss - 1) <= LOSS_RTOL
    assert metrics["aux"].item() == float(jm["aux"]) == 0.0
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), grads)}
    got = jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(grads, cfg))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path), err)


def _port_state(cfg, seed):
    model = PF.from_state_dict(cfg, lm_params_to_torch(
        seeded_lm_params(cfg, seed, max_seq=MAX_SEQ), cfg, "cpu"))
    return init_train_state(model, cfg, OptConfig(**KW))


def _leaves_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            jax.tree_util.keystr(path)


def test_checkpoints_cross_both_ways(tmp_path):
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = seeded_lm_params(cfg, 0, max_seq=MAX_SEQ)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**KW)))
    jstate = {"params": jparams(tree),
              "opt": {k: jax.tree_util.tree_map(jnp.zeros_like, tree)
                      for k in ("m", "v")},
              "step": jnp.zeros((), jnp.int32)}
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    jstate, _ = jstep(jstate, jparams(batch))
    JC.save(str(tmp_path / "ref"), 1, jstate)
    state = restore(str(tmp_path / "ref"), 1, _port_state(cfg, 1), cfg)
    assert state["step"] == 1
    _leaves_equal(train_state_to_numpy(state, cfg),
                  jax.tree_util.tree_map(np.asarray, jstate))
    state, _ = make_train_step(cfg, OptConfig(**KW))(
        state, to_device(make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 1),
                         "cpu"))
    save(str(tmp_path / "port"), 2, state, cfg)
    back = JC.restore(str(tmp_path / "port"), 2, jstate)
    _leaves_equal(jax.tree_util.tree_map(np.asarray, back),
                  train_state_to_numpy(state, cfg))


def test_async_saver(tmp_path):
    """tests/test_checkpoint.py::test_async_saver on the port: a Whisper
    train state saved by the async saver and restored, leaf for leaf."""
    cfg = get_reduced(ARCH)
    state = _port_state(cfg, 0)
    saver = AsyncSaver()
    saver.save_async(str(tmp_path), 1, state, cfg)
    saver.wait()
    assert latest_step(str(tmp_path)) == 1
    got = restore(str(tmp_path), 1, _port_state(cfg, 1), cfg)
    _leaves_equal(train_state_to_numpy(got, cfg),
                  train_state_to_numpy(state, cfg))


def test_golden_on_cpu():
    check_golden(ARCH)


def test_train_launcher_whisper(capsys):
    train_launcher.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                         "--seq", "16", "--device", "cpu"])
    assert "[train] done: 2 steps, final loss" in capsys.readouterr().out
