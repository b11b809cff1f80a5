"""The head_dim split of the port's model axis, its replicated attention
and RWKV's cut heads (``make_train_step(cfg, opt_cfg, ctx)`` with a
('data', 'model') mesh of the CPU), and ``launch/train.py --mesh``:

  · ``attention.seqpar_attention`` alone, causal and not, on 2, 4 and 8
    slabs of 128 queries (GQA 6 q / 2 KV heads of 16): within 2e-5 of
    the port's whole-sequence ``attention_plain`` and of the reference's
    ``chunked_attention`` run in-process, its gradient within 1e-5 of
    the whole attention's largest;
  · the step against the port's unsharded step, 3 steps: reduced
    qwen2-vl-2b on (1, 4) at 2 x 512 (the head_dim split through
    ``seqpar_attention``: each position's K3' call on its slab of 128
    queries, over the keys up to its slab's end) and at 4 x 32 (the
    head_dim split's one call on whole heads), phi3-medium-14b on (2, 8)
    (2 head_dim columns a position) and (1, 3) (the attention
    replicated), rwkv6-1.6b on (1, 8) (heads of 16 cut into columns of
    8); loss and ce within 1e-5 relative, grad_norm 1e-4, the
    parameters within 1e-4 of each leaf's largest magnitude, every
    step's gradients too.  For phi3-medium-14b, whose seeded embedding
    holds an element that AdamW's eps makes ill-conditioned (see
    ``ILL_CONDITIONED``), the parameters are held as
    test_torch_train.py holds AdamW trajectories, in units of lr;
  · the same bits with the model positions on two devices (two names of
    the CPU) as on one;
  · against the JAX package's own sharded step under ``make_ctx`` of a
    (1, 4) host mesh (4 forced host devices, in a subprocess): reduced
    qwen2-vl-2b at 2 x 512, where the reference too takes
    ``seqpar_attention``, 2 steps;
  · ``launch/train.py --mesh single`` (reduced qwen2-vl-2b) and
    ``--mesh multi`` (reduced minitron-8b) end at ``--mesh none``'s
    loss, and so do the MoE, MLA and jamba configs at ``--mesh single``
    against the unsharded step with the same token groups.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import chunked_attention
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_ctx, make_train_mesh
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import rwkv6 as rwkv_mod
from repro_torch.models.layers.attention import seqpar_attention
from repro_torch.train import train_step as TS
from test_torch_shard_train import (SHAPE, assert_rows_close,
                                    check_against_reference, cpu_ctx,
                                    launcher_loss, leaf_err, params_of,
                                    run, weights, whole_grads)
from test_torch_train import PARAM_LR_TOL, PARAM_SHARE

ATTN_TOL = 2e-5
GRAD_TOL = 1e-5           # of the whole attention's largest gradient
PARAM_TOL = 1e-4          # of each leaf's largest magnitude
LONG = ShapeSpec("t", 512, 2, "train")
# phi3-medium-14b's seeded embedding, at SHAPE's batches of DATA_SEED:
# element (72, 46)'s gradient at step 1 is a sum that cancels to 4.1e-7
# (3.5e-7 on any model axis, 5e-7 of the leaf's largest either way),
# which clipping takes to ~3.6e-8, near AdamW's eps of 1e-8, so its
# update moves by 5 % with the rounding: 4.0e-4 of the leaf's largest
# after 3 steps on (2, 8), 3.2e-4 on the head split (2, 4) as well.
ILL_CONDITIONED = ("phi3-medium-14b",)
CASES = [("qwen2-vl-2b", (1, 4), LONG), ("qwen2-vl-2b", (1, 4), SHAPE),
         ("phi3-medium-14b", (2, 8), SHAPE),
         ("phi3-medium-14b", (1, 3), SHAPE), ("rwkv6-1.6b", (1, 8), SHAPE)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(tp, seed, requires_grad=False):
    gen = torch.Generator().manual_seed(seed)
    s = 128 * tp
    q = torch.randn((2, s, 6, 16), generator=gen)
    k = torch.randn((2, s, 2, 16), generator=gen)
    v = torch.randn((2, s, 2, 16), generator=gen)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "non_causal"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_seqpar_attention(tp, causal):
    q, k, v = _qkv(tp, tp + 10 * causal, requires_grad=True)
    devs = [torch.device("cpu")] * tp
    got = seqpar_attention(q, k, v, causal=causal, devices=devs)
    whole = attention_plain(q, k, v, causal=causal)
    assert float((got - whole).detach().abs().max()) <= ATTN_TOL
    rep = [jnp.asarray(np.repeat(t.detach().numpy(), 3, axis=2))
           for t in (k, v)]
    ref = np.asarray(chunked_attention(jnp.asarray(q.detach().numpy()),
                                       *rep, causal=causal))
    assert float(np.abs(got.detach().numpy() - ref).max()) <= ATTN_TOL
    gen = torch.Generator().manual_seed(99)
    do = torch.randn(got.shape, generator=gen)
    g_got = torch.autograd.grad(got, (q, k, v), do)
    g_want = torch.autograd.grad(whole, (q, k, v), do)
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(
            b.abs().max())


def test_seqpar_slabs_see_their_causal_keys(monkeypatch):
    """A causal slab m runs K3' on its 128 queries over keys [0, (m+1)
    128): K3''s right-aligned mask is then the global one."""
    calls = []
    real = attn_mod.flash_attention

    def counted(q, k, v, *, causal):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(attn_mod, "flash_attention", counted)
    q, k, v = _qkv(4, 0)
    seqpar_attention(q, k, v, causal=True, devices=["cpu"] * 4)
    seqpar_attention(q, k, v, causal=False, devices=["cpu"] * 4)
    assert calls == [(128, 128 * (m + 1), True) for m in range(4)] + \
        [(128, 512, False)] * 4


def _grads_per_step(monkeypatch):
    """Each step's gradients, recorded by side (sharded or not)."""
    seen = {True: [], False: []}
    real = TS._step_grads

    def record(state, batch, cfg, ctx):
        metrics, grads = real(state, batch, cfg, ctx)
        seen[ctx.mesh is not None].append(
            {n: g.detach().clone()
             for n, g in whole_grads(grads, state).items()})
        return metrics, grads

    monkeypatch.setattr(TS, "_step_grads", record)
    return seen


def _assert_params_in_lr(got, want, lr, n_steps):
    """test_torch_train.py's hold of AdamW trajectories: every element
    within n_steps lr, all but a PARAM_SHARE of them within PARAM_LR_TOL
    lr."""
    far = total = 0
    for n, w in want.items():
        d = (got[n] - w).abs()
        assert float(d.max()) <= n_steps * lr, n
        far += int((d > PARAM_LR_TOL * lr).sum())
        total += d.numel()
    assert far <= PARAM_SHARE * total, (far, total)


@pytest.mark.parametrize("arch,mesh,shape", CASES, ids=[
    f"{a}-{'x'.join(map(str, m))}-{s.global_batch}x{s.seq_len}"
    for a, m, s in CASES])
def test_step_matches_unsharded(monkeypatch, arch, mesh, shape):
    cfg = get_reduced(arch)
    ctx = cpu_ctx(mesh)
    q_shapes = []
    real = attn_mod.flash_attention

    def counted(q, k, v, *, causal):
        q_shapes.append((tuple(q.shape), k.shape[1]))
        return real(q, k, v, causal=causal)

    seen = _grads_per_step(monkeypatch)
    want_rows, want = run(cfg, weights(cfg), None, shape, 3)
    monkeypatch.setattr(attn_mod, "flash_attention", counted)
    rows, state = run(cfg, weights(cfg), ctx, shape, 3)
    assert_rows_close(rows, want_rows)
    for got_g, want_g in zip(seen[True], seen[False]):
        err, leaf = leaf_err(got_g, want_g)
        assert err <= PARAM_TOL, (leaf, err)
    if arch in ILL_CONDITIONED:
        _assert_params_in_lr(params_of(state), params_of(want), 1e-3, 3)
    else:
        err, leaf = leaf_err(params_of(state), params_of(want))
        assert err <= PARAM_TOL, (leaf, err)
    # the path each case takes, as the rules place its attention
    specs = {n: sh.spec for n, sh in state["placed"].items()}
    b, s = shape.global_batch, shape.seq_len
    rows_per = b // ctx.dp_size
    if cfg.family == "ssm":
        assert specs["groups.0.0.tm.wr"] == (None, None, "model")
        assert not q_shapes
        return
    wq = specs["groups.0.0.attn.wq"]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    tp = ctx.tp_size
    # forward and recompute, per layer and data position, 3 steps
    n_calls = 3 * 2 * cfg.n_layers * ctx.dp_size
    if wq == (None, None, None, "model") and s // tp >= 128:
        sg = s // tp
        assert q_shapes == [((rows_per, sg, h, hd), (m + 1) * sg)
                            for m in range(tp)] * n_calls
    else:
        assert wq in ((None, None, None, "model"), (None, None, None, None))
        assert q_shapes == [((rows_per, s, h, hd), s)] * n_calls


def test_cut_heads_run_the_wkv_once_on_all_heads(monkeypatch):
    """rwkv6-1.6b reduced on (1, 8): d_model 64 splits into columns of 8,
    half a head of 16; K2 runs on all 4 heads once per data position,
    in the forward and the recompute."""
    cfg = get_reduced("rwkv6-1.6b")
    calls = []
    real = rwkv_mod.wkv6

    def counted(r, *args, **kw):
        calls.append(tuple(r.shape))
        return real(r, *args, **kw)

    monkeypatch.setattr(rwkv_mod, "wkv6", counted)
    run(cfg, weights(cfg), cpu_ctx((1, 8)), SHAPE, 1)
    assert calls == [(4, 32, 4, 16)] * (2 * cfg.n_layers)


@pytest.mark.parametrize("arch,mesh,shape", [
    ("qwen2-vl-2b", (1, 4), LONG), ("phi3-medium-14b", (1, 8), SHAPE),
    ("rwkv6-1.6b", (1, 8), SHAPE)], ids=["seqpar", "head_dim", "cut_heads"])
def test_two_devices_give_the_same_bits(arch, mesh, shape):
    """Two names of the CPU ("cpu", "cpu:0") stand for two devices, the
    model positions alternating between them: the joins, the slabs and
    the wkv on whole heads move across, and 2 steps give the same bits
    as every position on one device."""
    cfg = get_reduced(arch)
    devs = ["cpu", torch.device("cpu", 0)] * (mesh[1] // 2)
    want_rows, want = run(cfg, weights(cfg), cpu_ctx(mesh), shape, 2)
    rows, state = run(cfg, weights(cfg), make_ctx(make_train_mesh(
        mesh, devices=devs)), shape, 2)
    assert rows == want_rows
    assert state["params"] is None              # no device holds it all
    got = TS.plain_state(state)["params"].state_dict()
    for n, t in params_of(want).items():
        assert torch.equal(got[n], t), n


def test_matches_the_reference_sharded_step_through_seqpar(tmp_path):
    check_against_reference("qwen2-vl-2b", (1, 4), tmp_path, LONG)


def _final_loss(monkeypatch, argv):
    """The launcher's state and its last step's loss, as the step
    returned it."""
    last = {}
    real = train_launcher.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            last["loss"] = float(metrics["loss"])
            return state, metrics

        return recorded

    monkeypatch.setattr(train_launcher, "make_train_step", make)
    state = train_launcher.main(argv)
    return state, last["loss"]


@pytest.mark.parametrize("arch,mesh,shape", [
    ("qwen2-vl-2b", "single", (16, 16)),
    ("minitron-8b", "multi", (2, 16, 16))])
def test_launcher_mesh_trains_to_the_unsharded_loss(monkeypatch, capsys,
                                                    arch, mesh, shape):
    argv = ["--arch", arch, "--device", "cpu", "--steps", "2"]
    _, want = _final_loss(monkeypatch, argv)
    state, got = _final_loss(monkeypatch, argv + ["--mesh", mesh])
    assert state["ctx"].mesh.devices.shape == shape
    assert state["ctx"].tp_size == 16
    assert abs(got - want) <= 1e-5 * abs(want)
    assert "[train] done: 2 steps, final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_launcher_mesh_refuses_the_families_of_11d_5b_2b(monkeypatch, arch):
    """``--mesh single`` once refused the MoE, MLA and jamba configs; now
    it trains each on (16, 16) of the CPU: 4 rows that the 16 data
    positions do not divide run on the first in 16 token groups, the
    model axis splitting what 16 divides (deepseek's d_ff, jamba's
    d_inner), and the step's loss is the unsharded step's with the same
    groups."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "1"]
    _, want = launcher_loss(monkeypatch, argv, moe_groups=16)
    state, got = launcher_loss(monkeypatch, argv + ["--mesh", "single"])
    assert state["ctx"].mesh.devices.shape == (16, 16)
    assert abs(got - want) <= 1e-5 * abs(want)
