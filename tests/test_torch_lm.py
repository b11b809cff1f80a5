"""The port's RWKV-6 serving path (``repro_torch.models``) against the JAX
package's, on the reduced ``rwkv6-1.6b`` with the same seeded weights
(``repro_torch.convert.seeded_lm_params``, carried to both packages).

  · ``init_cache`` leaves equal in shape and dtype; the seeded parameter
    tree has the leaf names and shapes of ``jax.eval_shape`` of the JAX
    ``init_params``;
  · prefill logits and cache, one decode step, and ``generate`` tokens
    against the JAX package: logits within rtol/atol 1e-4, tokens equal
    (the seed's top-2 logit margins are above 1e-3, asserted);
  · the same numbers against tests/golden/torch_port_rwkv6_reduced.json,
    which the chip smoke checks on the card;
  · decode from the cache equals a teacher-forced prefill;
  · the port's LM modules import neither jax nor repro.

Regenerate the golden file from the JAX package with
    PYTHONPATH=src python tests/test_torch_lm.py --regen
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.factory as JF
import repro.models.lm as JL
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
import repro_torch.models.factory as PF
import repro_torch.models.lm as PL
from repro_torch.configs import ShapeSpec, get_config, get_reduced
from repro_torch.convert import (lm_cache_to_numpy, lm_cache_to_torch,
                                 lm_params_to_torch, params_fingerprint,
                                 seeded_lm_params)
from repro_torch.launch import serve_decode

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden", "torch_port_rwkv6_reduced.json")
ARCH = "rwkv6-1.6b"
WEIGHT_SEED, PROMPT_SEED = 0, 1
BATCH, PROMPT_LEN, MAX_NEW = 2, 128, 8      # the prompt is two chunks of 64
TOL = dict(rtol=1e-4, atol=1e-4)
MIN_MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prompt(cfg):
    rng = np.random.default_rng(PROMPT_SEED)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)


def top2_margin(logits) -> float:
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


def jax_reference(tree, cfg, toks):
    """Prefill logits, cache, the first decode step's logits, the greedy
    tokens and the least top-2 margin along the greedy path."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, cache = JF.prefill(params, {"tokens": jnp.asarray(toks)},
                               cfg=cfg)
    margins = [top2_margin(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    toks_out = [tok]
    step_cache, dec_logits = cache, None
    for i in range(MAX_NEW - 1):
        lg, step_cache = JF.decode(params, step_cache, {"tokens": tok},
                                   cfg=cfg)
        if i == 0:
            dec_logits = lg
        margins.append(top2_margin(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        toks_out.append(tok)
    return {"prefill_logits": np.asarray(logits), "cache": cache,
            "decode_logits": np.asarray(dec_logits),
            "tokens": np.asarray(jnp.concatenate(toks_out, 1)),
            "min_margin": min(margins)}


@pytest.fixture(scope="module")
def case():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = seeded_lm_params(cfg, WEIGHT_SEED)
    toks = prompt(cfg)
    model = PL.LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))
    return cfg, jcfg, tree, toks, model, jax_reference(tree, jcfg, toks)


def close(got, want):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got)
                               else np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,getter", [(ARCH, "get_reduced"),
                                         (ARCH, "get_config")])
def test_init_cache_layout(arch, getter):
    cfg = {"get_reduced": get_reduced, "get_config": get_config}[getter](arch)
    jcfg = {"get_reduced": jget_reduced, "get_config": jget_config}[getter](
        arch)
    want = jax.eval_shape(lambda: JL.init_cache(jcfg, 3, 40))
    got = PF.init_cache(cfg, 3, 40, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(lm_cache_to_numpy(got))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert w.shape == g.shape and w.dtype == g.dtype
        assert not g.any()


def test_seeded_tree_matches_jax_init():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    want = jax.eval_shape(lambda k: JF.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = seeded_lm_params(cfg, WEIGHT_SEED)
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (a.shape, str(a.dtype)), t)
    assert shapes(got) == shapes(want)
    # the port's random init has the same leaves as its seeded one
    model = PF.init_params(0, cfg, device="cpu")
    sd = lm_params_to_torch(got, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert PL.LM.from_state_dict(cfg, sd).state_dict().keys() == sd.keys()


def test_batches_match_jax_specs():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    shape = ShapeSpec("p", 16, 3, "prefill")
    want = JF.batch_specs(jcfg, shape)
    got = PF.make_batch(5, cfg, shape, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.int32 and want[k].dtype == jnp.int32
        assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab_size
    assert torch.equal(got["tokens"],
                       PF.make_batch(5, cfg, shape, device="cpu")["tokens"])
    want = JF.decode_batch_specs(jcfg, shape)
    got = PF.make_decode_batch(6, cfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_prefill_matches_jax(case):
    cfg, _, _, toks, model, ref = case
    logits, cache = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                               cfg=cfg)
    assert logits.shape == (BATCH, cfg.padded_vocab(32))
    close(logits, ref["prefill_logits"])
    got = lm_cache_to_numpy(cache)
    want = jax.tree_util.tree_map(np.asarray, ref["cache"])
    assert np.array_equal(got["len"], want["len"])
    for g, w in zip(got["groups"], want["groups"]):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            close(g[k], w[k])


def test_decode_step_matches_jax(case):
    """One decode step from the JAX package's own cache, carried across."""
    cfg, _, _, _, model, ref = case
    cache = lm_cache_to_torch(jax.tree_util.tree_map(np.asarray,
                                                     ref["cache"]), "cpu")
    tok = torch.from_numpy(ref["tokens"][:, :1].copy())
    logits, new = PF.decode(model, cache, {"tokens": tok}, cfg=cfg)
    close(logits, ref["decode_logits"])
    assert new["len"].tolist() == [PROMPT_LEN + 1] * BATCH


def test_generate_matches_jax(case):
    cfg, jcfg, tree, toks, model, ref = case
    assert ref["min_margin"] > MIN_MARGIN, ref["min_margin"]
    got = PF.generate(model, cfg, torch.from_numpy(toks), max_new=MAX_NEW)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref["tokens"])
    want = JF.generate(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                       jnp.asarray(toks), max_new=MAX_NEW)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_golden_on_cpu(case):
    """The golden file the chip smoke holds the card to is the JAX
    package's result, and the port on the CPU meets it."""
    cfg, _, tree, toks, model, ref = case
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["weights_sum"] == pytest.approx(params_fingerprint(tree),
                                                  rel=1e-9)
    assert np.array_equal(np.asarray(golden["prompt"], np.int32), toks)
    for key in ("prefill_logits", "decode_logits"):
        close(np.asarray(golden[key], np.float32), ref[key])
    assert np.array_equal(np.asarray(golden["tokens"]), ref["tokens"])
    logits, _ = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                           cfg=cfg)
    close(logits, np.asarray(golden["prefill_logits"], np.float32))


@pytest.mark.parametrize("s,steps", [(16, 1), (64, 1), (128, 64)])
def test_cache_consistency(case, s, steps):
    """decode-from-cache ≡ teacher-forced prefill
    (tests/test_models_smoke.py::test_cache_consistency): a prefill of
    s − steps tokens plus `steps` decode steps against a prefill of s
    tokens.  (128, 64) prefills two chunks against one chunk and 64 steps:
    127 tokens would not split into chunks of 64."""
    cfg, _, _, toks, model, _ = case
    t = torch.from_numpy(toks[:, :s].copy())
    full, _ = PF.prefill(model, {"tokens": t}, cfg=cfg)
    dec, cache = PF.prefill(model, {"tokens": t[:, :s - steps]}, cfg=cfg)
    for i in range(s - steps, s):
        dec, cache = PF.decode(model, cache, {"tokens": t[:, i:i + 1]},
                               cfg=cfg)
    assert cache["len"].tolist() == [s] * BATCH
    assert float((full - dec).abs().max()) < 2e-3


def test_entry_points_need_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PF.init_params(0, get_reduced(ARCH))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_decode.main([])


def test_serve_decode_cli(capsys):
    serve_decode.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "16", "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"[{ARCH}] batch=2 prompt=16 new=4: ")
    assert lines[0].endswith(" tok/s")
    assert len(json.loads(lines[1].split(":", 1)[1])) == 4


def test_lm_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.models.factory, repro_torch.launch.serve_decode\n"
        "import repro_torch.convert\n"
        "import repro_torch.launch.hlo_analysis, repro_torch.launch.hlo_costs\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.perf_probe\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _regen():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = seeded_lm_params(cfg, WEIGHT_SEED)
    toks = prompt(cfg)
    ref = jax_reference(tree, jcfg, toks)
    assert ref["min_margin"] > MIN_MARGIN, ref["min_margin"]
    golden = {
        "arch": ARCH, "config": "reduced", "weight_seed": WEIGHT_SEED,
        "weights_sum": params_fingerprint(tree),
        "prompt": toks.tolist(), "max_new": MAX_NEW,
        "min_top2_margin": ref["min_margin"],
        "prefill_logits": ref["prefill_logits"].tolist(),
        "decode_logits": ref["decode_logits"].tolist(),
        "tokens": ref["tokens"].tolist(),
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
