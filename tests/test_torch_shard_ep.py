"""The model axis of the MoE, MLA and jamba families in the port's sharded
train step (``make_train_step(cfg, opt_cfg, ctx)``, train/train_step.py),
on meshes of the CPU:

  · expert placement by ``ctx.ep_axes`` in each of its modes, 3 steps
    against the JAX package's step under a ctx of the same axis sizes
    whose hints are dropped (test_torch_shard_moe.py's ``UnhintedCtx``:
    the reference's token groups, capacities and balance loss on one
    device): '2d' reduced arctic-480b on (2, 2), 'full' deepseek-v3-671b
    on (1, 4), 'tp' jamba-v0.1-52b on (3, 2), replicated arctic on (1,
    3); loss, ce and aux within 1e-5 relative, grad_norm within 1e-4,
    parameters within 1e-4 of each leaf's largest magnitude; each
    position's stored expert blocks have the mode's shape;
  · MLA's head split and Mamba's d_inner split at tp 2 and 4 against the
    unsharded layer, forward and gradients, within 1e-5 of the largest;
  · the router, MLA's latents and Mamba's ``wxp`` sum run once per data
    position (forward and checkpointed recompute), not once per model
    position;
  · two names of the CPU as two devices: each stores only its experts'
    blocks, and the steps give the same bits as one device;
  · a sharded checkpoint of an MoE model on (2, 2) is the unsharded file
    and restarts bit for bit.
(The JAX package's own sharded step on 4 forced host devices for these
families is in test_torch_shard_train.py, beside its helper.)
"""
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import lm_params_to_torch
from repro_torch.launch.mesh import make_ctx, make_train_mesh
from repro_torch.models import lm
from repro_torch.models.layers import mamba as mamba_mod
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.parallelism import sharding as shd
from repro_torch.train import train_step as TS
from test_torch_shard_moe import flat_ref, grouped_reference
from test_torch_shard_seqpar import _assert_params_in_lr
from test_torch_shard_tp import check_checkpoint_restarts
from test_torch_shard_train import (PARAM_TOL, SHAPE, assert_rows_close,
                                    cpu_ctx, leaf_err, params_of, run,
                                    weights)

LAYER_TOL = 1e-5          # of the unsharded layer's largest magnitude
# mode -> (arch, mesh, batch): every batch splits into dp token groups
MODES = {"2d": ("arctic-480b", (2, 2), SHAPE),
         "full": ("deepseek-v3-671b", (1, 4), SHAPE),
         "tp": ("jamba-v0.1-52b", (3, 2), ShapeSpec("t", 16, 6, "train")),
         "replicated": ("arctic-480b", (1, 3), SHAPE)}
# deepseek-v3-671b's seeded embedding, at SHAPE's batches of DATA_SEED:
# element (219, 56)'s gradient at step 2 is a sum that cancels to -6.4e-7
# unsharded and -9.5e-7 on (1, 4) (1.5e-6 of its row's largest, 0.42),
# and AdamW's first normalised steps turn that rounding into 4.1e-5 of a
# leaf whose largest is 0.08 (5e-4 of it; 8.6e-5 unsharded against the
# reference).  That leaf is held in units of lr, as test_torch_shard_
# seqpar.py holds phi3-medium-14b's (``ILL_CONDITIONED`` there), every
# other leaf within PARAM_TOL.
ILL_CONDITIONED = {"deepseek-v3-671b": ("embed.emb",)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mode_of(ctx, cfg) -> str:
    ep, ff = ctx.ep_axes(cfg.moe.n_experts, cfg.moe.d_ff_expert)
    if ff is not None:
        return "2d"
    if isinstance(ep, tuple):
        return "full"
    return "tp" if ep is not None else "replicated"


def expert_block_shape(mode, cfg, dp, tp) -> tuple:
    """A position's block of ``moe.wi_gate`` (E, d, F) in ``mode``."""
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    return {"2d": (e // dp, d, f // tp), "full": (e // (dp * tp), d, f),
            "tp": (e // tp, d, f), "replicated": (e, d, f)}[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_placement_follows_the_reference_groups(mode):
    arch, mesh, shape = MODES[mode]
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    ctx = cpu_ctx(mesh)
    dp, tp = ctx.dp_size, ctx.tp_size
    assert mode_of(ctx, cfg) == mode
    assert moe_mod.moe_groups(dp, shape.global_batch * shape.seq_len,
                              cfg.moe.top_k) == dp
    tree = weights(cfg)
    want_rows, want = grouped_reference(jcfg, tree, mesh, shape, 3)
    rows, state = run(cfg, tree, ctx, shape, 3)
    assert_rows_close(rows, want_rows, aux=True)
    assert all(r["aux"] > 0 for r in rows)
    got, ref = params_of(state), flat_ref(want["params"], cfg)
    ill = ILL_CONDITIONED.get(arch, ())
    err, leaf = leaf_err(got, {n: w for n, w in ref.items() if n not in ill})
    assert err <= PARAM_TOL, (leaf, err)
    _assert_params_in_lr(got, {n: torch.as_tensor(ref[n]) for n in ill},
                         1e-3, 3)
    assert not state["replicas"]
    block = expert_block_shape(mode, cfg, dp, tp)
    for name, sh in state["placed"].items():
        if name.endswith("moe.wi_gate"):
            assert all(tuple(t.shape) == block for t in sh.blocks), name


def _layer(cfg, prefix):
    """{leaf name under prefix: a copy that requires grad} of the seeded
    weights."""
    state = lm_params_to_torch(weights(cfg), cfg, "cpu")
    flat = {k[len(prefix):]: v.clone().requires_grad_(True)
            for k, v in state.items() if k.startswith(prefix)}
    return flat


def _nest(flat):
    """{"q_norm.scale": t} as {"q_norm": {"scale": t}}."""
    out = {}
    for k, v in flat.items():
        head, _, leaf = k.rpartition(".")
        (out.setdefault(head, {}) if head else out)[leaf] = v
    return out


def _split(flat, dims, tp):
    """tp blocks of the leaves: ``dims[name]`` the dimension the rules
    split, the others whole (the same tensor at every position)."""
    return [_nest({k: (v.chunk(tp, dims[k])[j] if k in dims else v)
                   for k, v in flat.items()}) for j in range(tp)]


def _check_split(whole_fn, group_fn, flat, x):
    want = whole_fn()
    leaves = list(flat.values()) + [x]
    gw = torch.autograd.grad(want.square().sum(), leaves)
    got = group_fn()
    gg = torch.autograd.grad(got.square().sum(), leaves)
    assert float((got - want).abs().max()) <= \
        LAYER_TOL * float(want.abs().max())
    for name, a, b in zip(list(flat) + ["x"], gg, gw):
        assert float((a - b).abs().max()) <= \
            LAYER_TOL * float(b.abs().max()), name


@pytest.mark.parametrize("tp", [2, 4])
def test_mla_head_split(tp):
    """deepseek-v3-671b reduced (4 heads) on a model axis of tp: each
    position attends with its heads from the latents made once, its
    output partials added; against mla_train."""
    cfg = get_reduced("deepseek-v3-671b")
    flat = _layer(cfg, "groups.0.0.mla.")
    gen = torch.Generator().manual_seed(tp)
    x = torch.randn((2, 16, cfg.d_model), generator=gen, requires_grad=True)
    pos = lm.make_positions(cfg, 2, 16)
    dims = {"wuq": 1, "wuk": 1, "wuv": 1, "wo": 0}
    _check_split(
        lambda: mla_mod.mla_train(_nest(flat), x, cfg=cfg, positions=pos),
        lambda: mla_mod.mla_group(_split(flat, dims, tp), x, cfg=cfg,
                                  positions=pos, devices=["cpu"] * tp),
        flat, x)


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_d_inner_split(tp):
    """jamba-v0.1-52b reduced (d_inner 128) on a model axis of tp: each
    position runs its channels, the wxp partials summed before the
    softplus and the wo partials after; against mamba_train."""
    cfg = get_reduced("jamba-v0.1-52b")
    flat = _layer(cfg, "groups.0.0.sub0.mamba.")
    gen = torch.Generator().manual_seed(tp)
    x = torch.randn((2, 16, cfg.d_model), generator=gen, requires_grad=True)
    di = cfg.ssm.expand * cfg.d_model
    dims = {"wx": 1, "wz": 1, "conv_w": 1, "conv_b": 0, "wxp": 0, "wdt": 1,
            "dt_bias": 0, "A_log": 0, "D": 0, "wo": 0}
    zc = torch.zeros((2, cfg.ssm.d_conv - 1, di))
    zh = torch.zeros((2, di, cfg.ssm.d_state))
    _check_split(
        lambda: mamba_mod.mamba_train(_nest(flat), x, zc, zh, cfg=cfg)[0],
        lambda: mamba_mod.mamba_group(_split(flat, dims, tp), x, cfg=cfg,
                                      devices=["cpu"] * tp),
        flat, x)


@pytest.mark.parametrize("arch,module,name,per_layer", [
    ("deepseek-v3-671b", mla_mod, "_latents", "mla"),
    ("deepseek-v3-671b", moe_mod, "route", "moe"),
    ("jamba-v0.1-52b", mamba_mod, "wxp_sum", "mamba"),
    ("jamba-v0.1-52b", moe_mod, "route", "moe")])
def test_replicated_parts_run_once_per_data_position(monkeypatch, arch,
                                                     module, name,
                                                     per_layer):
    """On (2, 2) each data position's 2 rows run the router, MLA's
    latents and the sum of Mamba's wxp partials once per layer (forward
    and checkpointed recompute), never once per model position."""
    cfg = get_reduced(arch)
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    run(cfg, weights(cfg), cpu_ctx((2, 2)), SHAPE, 1)
    if cfg.block_pattern is None:
        n = {"mla": cfg.n_layers,
             "moe": cfg.n_layers - cfg.n_dense_prefix}[per_layer]
    else:
        n = {"mamba": cfg.block_pattern.count("mamba"),
             "moe": len(cfg.block_pattern) // 2}[per_layer]
        n *= cfg.n_layers // len(cfg.block_pattern)
    assert len(calls) == 2 * n * 2
    if name == "_latents":                  # a data position's 2 rows
        assert all(a[1].shape[0] == 2 for a in calls)


def test_two_devices_store_only_their_experts():
    """Two names of the CPU ("cpu", "cpu:0") on a (2, 1) mesh: the
    experts split over the data axis, each device stores only its half
    of every expert leaf, and 3 steps give the same bits as one device."""
    cfg = get_reduced("arctic-480b")
    cpu0 = torch.device("cpu", 0)
    ctx = make_ctx(make_train_mesh((2, 1), devices=["cpu", cpu0]))
    assert mode_of(ctx, cfg) == "2d"
    want_rows, want = run(cfg, weights(cfg), cpu_ctx((2, 1)), SHAPE, 3)
    rows, state = run(cfg, weights(cfg), ctx, SHAPE, 3)
    assert rows == want_rows
    assert state["params"] is None and not state["replicas"]
    got = TS.plain_state(state)["params"].state_dict()
    for n, t in params_of(want).items():
        assert torch.equal(got[n], t), n
    n_expert = 0
    for name, sh in state["placed"].items():
        if not shd.is_expert_leaf(name):
            assert set(sh.wholes) == {torch.device("cpu"), cpu0}, name
            continue
        n_expert += 1
        assert not sh.wholes, name
        for p, dev in enumerate(ctx.mesh.devices.flat):
            (blk, t), = sh.stores[dev]
            assert t is sh.blocks[p] and t.shape[0] * 2 == got[name].shape[0]
            assert torch.equal(t, got[name][shd.index_of(blk)])
        for m in ("m", "v"):                # its moments likewise
            ms = state["opt"][m][name]
            assert [b for b, _ in ms.stores[cpu0]] == [sh.where[1]]
    assert n_expert == 3 * cfg.n_layers


def test_moe_checkpoint_is_the_unsharded_file_and_restarts(tmp_path):
    check_checkpoint_restarts("arctic-480b", cpu_ctx((2, 2)), tmp_path)


def test_expert_owners_by_mode():
    """Which positions run each expert block for data position 1's row on
    (2, 2) ('2d': block k's two d_ff halves at (k, 0) and (k, 1)) and on
    (1, 4) ('full': block k at position k), and for row 1 of (3, 2)
    ('tp': its own positions)."""
    where_2d = [((0, 2), (0, 8), (0, 4)), ((0, 2), (0, 8), (4, 8)),
                ((2, 4), (0, 8), (0, 4)), ((2, 4), (0, 8), (4, 8))]
    assert shd.expert_owners(where_2d, range(2, 4)) == [[0, 1], [2, 3]]
    where_full = [((k, k + 1), (0, 8), (0, 8)) for k in range(4)]
    assert shd.expert_owners(where_full, range(4)) == [[0], [1], [2], [3]]
    where_tp = [((2 * j, 2 * j + 2), (0, 8), (0, 8))
                for _ in range(3) for j in range(2)]
    assert shd.expert_owners(where_tp, range(2, 4)) == [[2], [3]]
    assert shd.expert_owners([((0, 4), (0, 8), (0, 8))] * 3,
                             range(3)) == [[0]]
