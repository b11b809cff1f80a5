"""The port's dense GQA serving path (``repro_torch.models``, the
``std:dense`` group kind) against the JAX package's, on reduced
``minitron-8b`` (LayerNorm, squared ReLU, GQA), ``qwen2-72b`` (RMSNorm,
SwiGLU, GQA, QKV bias), ``codeqwen1.5-7b`` (MHA, QKV bias),
``phi3-medium-14b`` (GQA, SwiGLU) and ``qwen2-vl-2b`` (M-RoPE, fed
``embeds`` as its vision frontend's stub), with the same seeded weights
(``repro_torch.convert.seeded_lm_params``, the constant leaves jittered
by ``jitter_constant_leaves``):

  · ``init_cache`` leaves equal in shape and dtype; the seeded tree has the
    leaf names and shapes of ``jax.eval_shape`` of the JAX ``init_params``;
  · prefill logits and KV cache (padded to max_len), one decode step from
    the JAX package's own cache, and ``generate`` tokens: logits within
    rtol/atol 1e-4, tokens equal (the top-2 logit margins along the greedy
    path are above 1e-3, asserted);
  · decode from the cache equals a teacher-forced prefill (the property of
    tests/test_models_smoke.py::test_cache_consistency, 2e-3);
  · tests/golden/torch_port_dense_reduced.json, which the chip smoke
    checks on the card, is the JAX package's result and the port meets it;
  · no module of the port, and not chip_smoke.py, imports jax or repro.

Regenerate the golden file from the JAX package with
    PYTHONPATH=src python tests/test_torch_dense_lm.py --regen
"""
import ast
import functools
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
from repro.configs import get_reduced as jget_reduced
import repro_torch.models.factory as PF
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (jitter_constant_leaves, lm_cache_to_numpy,
                                 lm_cache_to_torch, lm_params_to_torch,
                                 params_fingerprint, seeded_lm_params)
from repro_torch.launch import serve_decode
from repro_torch.models.lm import LM

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden", "torch_port_dense_reduced.json")
ARCHS = ["minitron-8b", "qwen2-72b", "codeqwen1.5-7b", "phi3-medium-14b",
         "qwen2-vl-2b"]
GOLDEN_ARCHS = ("minitron-8b", "qwen2-72b")
WEIGHT_SEED, JITTER_SEED, PROMPT_SEED = 0, 1, 2
BATCH, PROMPT_LEN, MAX_NEW = 2, 24, 6
TOL = dict(rtol=1e-4, atol=1e-4)
MIN_MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(cfg):
    return jitter_constant_leaves(seeded_lm_params(cfg, WEIGHT_SEED),
                                  JITTER_SEED)


def prompt(cfg):
    rng = np.random.default_rng(PROMPT_SEED)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)


def top2_margin(logits) -> float:
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


def jax_reference(tree, jcfg, toks):
    """Prefill logits and cache (max_len = prompt + MAX_NEW, as generate
    sizes it), the first decode step's logits, the greedy tokens and the
    least top-2 margin along the greedy path."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, cache = JF.prefill(params, {"tokens": jnp.asarray(toks)},
                               cfg=jcfg, max_len=PROMPT_LEN + MAX_NEW)
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
    """(cfg, tree, prompt, port model, JAX reference), once per arch."""
    cfg = get_reduced(arch)
    tree, toks = weights(cfg), prompt(cfg)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))
    return (cfg, tree, toks, model,
            jax_reference(tree, jget_reduced(arch), toks))


def close(got, want):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got)
                               else np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    want = jax.eval_shape(lambda: JL.init_cache(jcfg, 3, 40))
    got = lm_cache_to_numpy(PF.init_cache(cfg, 3, 40, device="cpu"))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert w.shape == g.shape and w.dtype == g.dtype
        assert not g.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_tree_matches_jax_init(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    want = jax.eval_shape(lambda k: JF.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = weights(cfg)
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (a.shape, str(a.dtype)), t)
    assert shapes(got) == shapes(want)
    model = PF.init_params(0, cfg, device="cpu")
    sd = lm_params_to_torch(got, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    cfg, _, toks, model, ref = case(arch)
    logits, cache = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                               cfg=cfg, max_len=PROMPT_LEN + MAX_NEW)
    assert logits.shape == (BATCH, cfg.padded_vocab(32))
    close(logits, ref["prefill_logits"])
    got, want = lm_cache_to_numpy(cache), ref["cache"]
    assert np.array_equal(got["len"], want["len"])
    for g, w in zip(got["groups"], want["groups"]):
        assert g.keys() == w.keys() == {"k", "v"}
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            close(g[k], w[k])
            assert not g[k][:, :, PROMPT_LEN:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """One decode step from the JAX package's own cache, carried across."""
    cfg, _, _, model, ref = case(arch)
    cache = lm_cache_to_torch(ref["cache"], "cpu")
    tok = torch.from_numpy(ref["tokens"][:, :1].copy())
    logits, new = PF.decode(model, cache, {"tokens": tok}, cfg=cfg)
    close(logits, ref["decode_logits"])
    assert new["len"].tolist() == [PROMPT_LEN + 1] * BATCH
    # the cache it was given is unchanged; the new one holds the token
    assert np.array_equal(cache["groups"][0]["k"].numpy(),
                          ref["cache"]["groups"][0]["k"])
    assert new["groups"][0]["k"][:, :, PROMPT_LEN].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    cfg, _, toks, model, ref = case(arch)
    assert ref["min_margin"] > MIN_MARGIN, ref["min_margin"]
    got = PF.generate(model, cfg, torch.from_numpy(toks), max_new=MAX_NEW)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref["tokens"])


def test_generate_equals_jax_generate():
    """The reference loop above is JAX's own generate."""
    cfg, tree, toks, _, ref = case("minitron-8b")
    want = JF.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                       jget_reduced("minitron-8b"), jnp.asarray(toks),
                       max_new=MAX_NEW)
    assert np.array_equal(np.asarray(want), ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,steps", [(16, 1), (24, 8)])
def test_cache_consistency(arch, s, steps):
    """decode-from-cache ≡ teacher-forced prefill
    (tests/test_models_smoke.py::test_cache_consistency): a prefill of
    s − steps tokens, sized for s, plus `steps` decode steps against a
    prefill of s tokens."""
    cfg, _, toks, model, _ = case(arch)
    t = torch.from_numpy(toks[:, :s].copy())
    full, _ = PF.prefill(model, {"tokens": t}, cfg=cfg)
    dec, cache = PF.prefill(model, {"tokens": t[:, :s - steps]}, cfg=cfg,
                            max_len=s)
    for i in range(s - steps, s):
        dec, cache = PF.decode(model, cache, {"tokens": t[:, i:i + 1]},
                               cfg=cfg)
    assert cache["len"].tolist() == [s] * BATCH
    assert float((full - dec).abs().max()) < 2e-3


def test_vision_embeds_match_jax():
    """qwen2-vl-2b fed precomputed patch embeddings: prefill and a decode
    step through ``embeds``, against the JAX package."""
    arch = "qwen2-vl-2b"
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = weights(cfg)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((BATCH, 12, cfg.d_model), dtype=np.float32)
    step = rng.standard_normal((BATCH, 1, cfg.d_model), dtype=np.float32)
    logits, cache = PF.prefill(model, {"embeds": torch.from_numpy(emb)},
                               cfg=cfg, max_len=16)
    jlogits, jcache = JF.prefill(params, {"embeds": jnp.asarray(emb)},
                                 cfg=jcfg, max_len=16)
    close(logits, jlogits)
    logits, _ = PF.decode(model, cache, {"embeds": torch.from_numpy(step)},
                          cfg=cfg)
    jlogits, _ = JF.decode(params, jcache, {"embeds": jnp.asarray(step)},
                           cfg=jcfg)
    close(logits, jlogits)


def test_vision_batches_match_jax_specs():
    arch = "qwen2-vl-2b"
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    shape = ShapeSpec("p", 16, 3, "prefill")
    want = JF.batch_specs(jcfg, shape, jnp.float32)
    got = PF.make_batch(5, cfg, shape, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    want = JF.decode_batch_specs(jcfg, shape, jnp.float32)
    got = PF.make_decode_batch(6, cfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["embeds"].dtype == torch.float32


@pytest.mark.parametrize("arch", GOLDEN_ARCHS)
def test_golden_on_cpu(arch):
    """The golden file the chip smoke holds the card to is the JAX
    package's result, and the port on the CPU meets it."""
    cfg, tree, toks, model, ref = case(arch)
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert (golden["weight_seed"], golden["jitter_seed"],
            golden["max_new"]) == (WEIGHT_SEED, JITTER_SEED, MAX_NEW)
    g = golden["archs"][arch]
    assert g["weights_sum"] == pytest.approx(params_fingerprint(tree),
                                             rel=1e-9)
    assert np.array_equal(np.asarray(golden["prompt"][arch], np.int32), toks)
    for key in ("prefill_logits", "decode_logits"):
        close(np.asarray(g[key], np.float32), ref[key])
    assert np.array_equal(np.asarray(g["tokens"]), ref["tokens"])
    logits, _ = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                           cfg=cfg, max_len=PROMPT_LEN + MAX_NEW)
    close(logits, np.asarray(g["prefill_logits"], np.float32))


def test_serve_decode_cli_dense(capsys):
    serve_decode.main(["--arch", "minitron-8b", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--max-new",
                       "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[minitron-8b] batch=2 prompt=16 new=3: ")
    assert lines[0].endswith(" tok/s")
    assert len(json.loads(lines[1].split(":", 1)[1])) == 3


def _imports(path):
    """Top-level names of the modules a source file imports."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    """Every module of src/repro_torch, imported in a fresh process, pulls
    in no jax and no repro; no import statement in them or in
    chip_smoke.py names either."""
    pkg = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    named = {f: sorted(set(_imports(f)) & {"jax", "jaxlib", "repro"})
             for f in files}
    assert not any(named.values()), named
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
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
    golden = {"config": "reduced", "weight_seed": WEIGHT_SEED,
              "jitter_seed": JITTER_SEED, "max_new": MAX_NEW,
              "max_len": PROMPT_LEN + MAX_NEW, "prompt": {}, "archs": {}}
    for arch in GOLDEN_ARCHS:
        cfg = get_reduced(arch)
        tree, toks = weights(cfg), prompt(cfg)
        ref = jax_reference(tree, jget_reduced(arch), toks)
        assert ref["min_margin"] > MIN_MARGIN, (arch, ref["min_margin"])
        golden["prompt"][arch] = toks.tolist()
        golden["archs"][arch] = {
            "weights_sum": params_fingerprint(tree),
            "min_top2_margin": ref["min_margin"],
            "prefill_logits": ref["prefill_logits"].tolist(),
            "decode_logits": ref["decode_logits"].tolist(),
            "tokens": ref["tokens"].tolist()}
    with open(GOLDEN, "w") as f:
        json.dump(golden, f)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
