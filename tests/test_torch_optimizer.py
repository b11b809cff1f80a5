"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's ``train/optimizer.py`` on a seeded tree of parameters,
gradients and moments:

  · ``lr_schedule`` equal in f32 at every step of warmup, cosine and
    after its end;
  · ``_decay_mask`` on every leaf name of the ported models' trees;
  · ``global_norm`` and ``adamw_update`` (clipped and not; f32 and bf16
    moments; steps 0, 1 and past warmup): the norm within 1e-6 relative,
    moments within 1e-6 of their largest magnitude (bf16: within one
    bf16 rounding), parameters within 1e-3 lr (AdamW's 1/(sqrt(v) + eps)
    turns an f32 rounding near eps into a move of order lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as J
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_to_torch, seeded_lm_params
from repro_torch.train import optimizer as P

KW = dict(peak_lr=1e-2, warmup_steps=4, total_steps=20)


def test_lr_schedule_matches_jax():
    for cfg in (J.OptConfig(**KW), J.OptConfig()):
        pcfg = P.OptConfig(**{f: getattr(cfg, f) for f in
                              cfg.__dataclass_fields__})
        for step in list(range(0, 30)) + [99, 100, 101, 5000, 10_000, 20_000]:
            want = np.float32(J.lr_schedule(cfg, jnp.int32(step)))
            got = P.lr_schedule(pcfg, step)
            assert got.dtype == torch.float32
            assert np.float32(got.item()) == want, step


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2-vl-2b"])
def test_decay_mask_matches_jax(arch):
    """The port's mask on each parameter's name equals the reference's on
    the leaf's tree path; both kinds occur."""
    cfg = get_reduced(arch)
    tree = seeded_lm_params(cfg, 0)
    want = {p[-1].key: J._decay_mask(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)}
    for name in lm_params_to_torch(tree, cfg, "cpu"):
        assert P._decay_mask(name) == want[name.rsplit(".", 1)[-1]], name
    assert not all(want.values()) and any(want.values())


def seeded_tree(seed, clip_scale):
    rng = np.random.default_rng(seed)
    shapes = {"embed.emb": (16, 8), "groups.0.0.attn.wq": (8, 2, 4),
              "groups.0.0.attn_norm.scale": (8,), "final_norm.bias": (8,),
              "groups.0.1.tm.u": (8,), "head.w": (8, 16)}
    f = np.float32
    params = {n: rng.standard_normal(s).astype(f) for n, s in shapes.items()}
    grads = {n: (clip_scale * rng.standard_normal(s)).astype(f)
             for n, s in shapes.items()}
    # a few gradient elements near eps, where AdamW is most sensitive
    grads["head.w"][0, :4] = 1e-9
    m = {n: (0.01 * rng.standard_normal(s)).astype(f)
         for n, s in shapes.items()}
    v = {n: (1e-4 * rng.random(s)).astype(f) for n, s in shapes.items()}
    return params, grads, m, v


def jtree(flat):
    """A flat dict as the nested dict JAX's optimizer walks (leaf names
    last, as the decay mask reads them)."""
    out = {}
    for name, x in flat.items():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(x)
    return out


def jflat(tree, prefix=""):
    out = {}
    for k, x in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(jflat(x, key) if isinstance(x, dict)
                   else {key: np.asarray(x, np.float32)})
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,clip_scale", [(0, 1.0), (1, 0.01), (6, 1.0),
                                             (6, 0.01)])
def test_adamw_update_matches_jax(step, clip_scale, moment_dtype):
    cfg = J.OptConfig(**KW, moment_dtype=moment_dtype)
    pcfg = P.OptConfig(**KW, moment_dtype=moment_dtype)
    params, grads, m, v = seeded_tree(step + int(100 * clip_scale),
                                      clip_scale)
    jdt = jnp.dtype(moment_dtype)
    jopt = {"m": jax.tree_util.tree_map(lambda x: x.astype(jdt), jtree(m)),
            "v": jax.tree_util.tree_map(lambda x: x.astype(jdt), jtree(v))}
    jp, jo, jn = J.adamw_update(jtree(grads), jopt, jtree(params), cfg,
                                jnp.int32(step))
    tdt = getattr(torch, moment_dtype)
    tp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
    tg = {n: torch.from_numpy(x.copy()) for n, x in grads.items()}
    topt = {"m": {n: torch.from_numpy(x).to(tdt) for n, x in m.items()},
            "v": {n: torch.from_numpy(x).to(tdt) for n, x in v.items()}}
    want_norm = float(J.global_norm(jtree(grads)))
    assert abs(P.global_norm(tg).item() / want_norm - 1) <= 1e-6
    out_p, out_o, norm = P.adamw_update(tg, topt, tp, pcfg, step)
    assert out_p is tp and out_o is topt
    assert abs(norm.item() / float(jn) - 1) <= 1e-6
    lr = float(J.lr_schedule(cfg, jnp.int32(step)))
    for name, want in jflat(jp).items():
        assert np.abs(tp[name].numpy() - want).max() <= 1e-3 * lr + 1e-12, \
            name
        if lr == 0:      # warmup's step 0 moves nothing
            assert np.array_equal(tp[name].numpy(), params[name])
    for k in ("m", "v"):
        for name, want in jflat(jo[k]).items():
            got = topt[k][name]
            assert got.dtype == tdt
            tol = (1e-6 * np.abs(want).max() if moment_dtype == "float32"
                   else 2 ** -8 * np.abs(want).max())
            assert np.abs(got.float().numpy() - want).max() <= tol, (k, name)
