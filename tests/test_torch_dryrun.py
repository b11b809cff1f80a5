"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

  · skip logic: 40 cells per production mesh, 32 runnable and 8 skipped
    with the reference's ``cfg.skipped_cells()`` reasons;
  · per-device parameter and moment bytes (``dryrun.state_bytes``, from
    shapes and specs, no tensor) equal to the reference's specs' shard
    bytes for every runnable cell of both production meshes;
  · a reduced dense cell (qwen2-vl-2b) and a reduced RWKV-6 cell, train
    and prefill, on (1, 1) and (2, 2) fake meshes: the FLOPs outside the
    kernels equal the JAX ``hlo_costs.analyze`` FLOPs of the reference's
    reduced step outside attention and the wkv, exactly (tolerance 0),
    and on (1, 1) so do the products' bytes and the updates' bytes
    (the reference's other byte kinds are XLA's own copies, slices and
    reduce-windows, which the port does not make).
    On (2, 2) the dense train step counts one product more a layer: the
    model axis's block checkpoint (``lm._GroupCheckpoint``) recomputes
    the FFN's down-projection, where the unsharded step's
    ``torch.utils.checkpoint`` stops at the last tensor the backward
    needs; every other cell equals its (1, 1) count;
  · the record: its keys, the arguments' bytes of each device equal to
    ``state_bytes`` (the batch beside them on the first), the kernels'
    calls;
  · the dry run's default dtype, bf16: the reduced train cell traces
    whole, K3' and ``flash_attention_bwd`` counted at bf16 bytes (the
    other cells here pass ``dtype=torch.float32``).
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import hlo_costs as jcosts
from repro.launch import perf_probe as jprobe
from repro.models import factory as JF
from repro.parallelism import sharding as jshd
from repro.parallelism.ctx import ShardCtx as JShardCtx
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import SHAPES, ShapeSpec, get_config, get_reduced
from repro_torch.configs import list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_ctx

# the reference's attention and wkv products, by their einsum (the
# last segments of their HLO op names): models/layers/attention.py
# direct_attention, models/layers/rwkv6.py wkv_chunked
KERNEL_EINSUMS = {"bqhk,bshk->bhqs", "bhqs,bshk->bqhk",
                  "bthi,bshi,btshi->bhts", "bhts,bshj->bthj",
                  "bthi,bhij->bthj", "bshi,bshj->bhij", "bthi,bthi->bth"}
REDUCED = ("qwen2-vl-2b", "rwkv6-1.6b")
SEQ, BATCH = 64, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_skip_logic_matches_the_reference():
    cells = [(a, n) for a in list_archs() for n in SHAPES]
    runnable = [(a, n) for a, n in cells
                if get_config(a).supports(SHAPES[n])]
    assert (len(cells), len(runnable)) == (40, 32)
    for arch, name in cells:
        ok = (arch, name) in runnable
        assert ok == jget_config(arch).supports(JSHAPES[name])
        if ok:
            continue
        for multi in (False, True):
            meta = dryrun.build_lowerable(arch, name, multi_pod=multi)[2]
            assert meta == {"skipped": True, "reason": jget_config(
                arch).skipped_cells()[0][1]}


@lru_cache(maxsize=None)
def _ref_bytes(arch: str, multi: bool, train: bool, max_seq: int) -> int:
    """The reference's per-device parameter (and moment) bytes: each leaf
    divided by the mesh sizes its spec names, f32 (moments at the dry
    run's dtype)."""
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi
             else {"data": 16, "model": 16})

    class Mesh:
        shape = sizes
        axis_names = tuple(sizes)

    jcfg = jget_config(arch)
    ctx = JShardCtx(mesh=Mesh(), batch_axes=tuple(
        a for a in ("pod", "data") if a in sizes), tp_axis="model")
    shapes = jax.eval_shape(lambda: JF.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32, max_seq=max_seq))
    pspecs = jshd.param_pspecs(shapes, jcfg, ctx)

    def shard_bytes(specs, itemsize):
        total = 0
        for x, spec in zip(jax.tree_util.tree_leaves(shapes),
                           jax.tree_util.tree_leaves(
                               specs, is_leaf=lambda s: isinstance(
                                   s, jax.sharding.PartitionSpec))):
            n = int(np.prod(x.shape))
            for entry in spec:
                for a in (() if entry is None else entry
                          if isinstance(entry, tuple) else (entry,)):
                    n //= sizes[a]
            total += n * itemsize
        return total

    total = shard_bytes(pspecs, 4)
    if train:
        big = jcfg.param_count() > 1e11
        total += 2 * shard_bytes(jshd.moments_pspecs(pspecs, shapes, ctx),
                                 2 if big else 4)
    return total


@pytest.mark.parametrize("multi", [False, True])
def test_state_bytes_match_the_reference_shards(multi):
    mesh, _ = dryrun._mesh(multi, None)
    ctx = make_ctx(mesh)
    cells = 0
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in cfg.cells():
            seq = shape.seq_len if cfg.enc_dec else 4096
            got = dryrun.state_bytes(cfg, ctx, train=shape.kind == "train",
                                     max_seq=seq)
            want = _ref_bytes(arch, multi, shape.kind == "train", seq)
            assert (got == want).all(), (arch, shape.name, got.min(),
                                         got.max(), want)
            cells += 1
    assert cells == 32


def _jax_step_text(arch: str, kind: str) -> str:
    jcfg = jget_reduced(arch)
    shape = ShapeSpec("cell", SEQ, BATCH, kind)
    params = jax.eval_shape(lambda: JF.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32, max_seq=SEQ))
    batch = JF.batch_specs(jcfg, shape, jnp.float32)
    if kind == "train":
        state = {"params": params, "opt": {"m": params, "v": params},
                 "step": jax.ShapeDtypeStruct((), jnp.int32)}
        fn, args = jmake_train_step(jcfg, JOptConfig()), (state, batch)
    else:
        fn = partial(JF.prefill, cfg=jcfg, max_len=SEQ)
        args = (params, batch)
    return jax.jit(fn).lower(*args).compile().as_text()


def _jax_outside_kernels(arch: str, kind: str) -> tuple:
    """(FLOPs, {op kind: HBM bytes}) of the reference's reduced step, by
    the JAX ``hlo_costs.analyze``, less what its ``perf_probe`` tags with
    attention's and the wkv's einsums."""
    txt = _jax_step_text(arch, kind)
    att = jprobe.attribute(txt)
    costs = jcosts.analyze(txt)
    assert sum(att["bytes"].values()) == costs.bytes
    inside = sum(f for tag, f in att["flops"].items()
                 if tag.split("/")[0] in KERNEL_EINSUMS)
    assert inside > 0
    nbytes = dict(costs.bytes_by_op)
    for (op, tag), b in att["bytes"].items():
        if tag.split("/")[0] in KERNEL_EINSUMS:
            nbytes[op] -= b
    return costs.flops - inside, nbytes


def _port_cell(arch: str, kind: str, mesh_shape, dtype=torch.float32):
    shape = ShapeSpec("cell", SEQ, BATCH, kind)
    return dryrun.cell_record(arch, "cell", False, cfg=get_reduced(arch),
                              shape=shape, mesh_shape=mesh_shape,
                              dtype=dtype, verbose=False)


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_reduced_cell_flops_match_the_reference_step(arch, kind):
    want, ref_bytes = _jax_outside_kernels(arch, kind)
    cfg = get_reduced(arch)
    got, recs = {}, {}
    for mesh in ((1, 1), (2, 2)):
        rec = recs[mesh] = _port_cell(arch, kind, mesh)
        assert "error" not in rec, rec.get("error")
        kernel_flops = sum(k["flops"] for k in rec["kernels"].values())
        assert kernel_flops > 0
        got[mesh] = rec["hlo_flops_global"] - kernel_flops
    assert got[(1, 1)] == want
    extra = 0
    if kind == "train" and arch == "qwen2-vl-2b":
        # the FFN's down-projection recomputed by the group checkpoint
        extra = 2 * BATCH * SEQ * cfg.d_ff * cfg.d_model * cfg.n_layers
    assert got[(2, 2)] == want + extra
    # HBM bytes outside the kernels on (1, 1), its one device's (on a
    # mesh each position reads its own blocks), by op kind, tolerance 0:
    # the products' operands and results as the reference's dots, the
    # embedding backward's update as its scatter-add.  The reference's
    # other kinds are XLA's own materialisations (layout copies and
    # transposes, the layer scan's slices and stacking, the cumsum's
    # reduce-window), listed by cell in PERF.md section 6.
    port = recs[(1, 1)]["bytes_by_op"]
    assert port["product"] == ref_bytes["dot"]
    assert port.get("update", 0) == ref_bytes.get("scatter", 0)


def test_record_counts_the_state_and_the_kernels():
    arch = "qwen2-vl-2b"
    cfg = get_reduced(arch)
    rec = _port_cell(arch, "train", (2, 2))
    ctx = make_ctx(dryrun._mesh(False, (2, 2))[0])
    state = dryrun.state_bytes(cfg, ctx, train=True, max_seq=SEQ)
    assert state.max() == state.min()
    batch = BATCH * SEQ * (cfg.d_model + 1) * 4           # embeds, labels
    # the first device holds its state and the whole batch
    assert rec["arg_bytes_per_dev"] == state[0] + batch
    assert rec["busiest"]["arg_bytes_per_dev"] == 0
    assert rec["compile_s"] is None and rec["lower_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo_flops_per_dev"] > 0 and rec["peak_bytes_per_dev"] > 0
    assert rec["peak_bytes_per_dev"] >= rec["arg_bytes_per_dev"]
    assert rec["peaks"]["card"] == "NVIDIA H100 SXM5 80GB"
    assert rec["peaks"]["peak_flops"] == 495e12 / 3
    # four positions: each layer's K3' once per position, forward and
    # recompute, and its backward once
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == {
        "flash_attention": 4 * 2 * cfg.n_layers,
        "flash_attention_bwd": 4 * cfg.n_layers}
    assert set(rec["collectives"]) >= {"fan_out", "row_sum", "zero1"}


def test_bf16_train_cell_records_the_backward_kernels_error():
    """The reduced train cell at the dry run's default dtype, bf16: it
    traces whole (no error recorded: the backward kernels take bf16), K3'
    and its backward counted per layer at bf16 bytes by their own cost
    formulas, the step's bound at the bf16 peak."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.launch import hlo_analysis
    arch = "qwen2-vl-2b"
    cfg = get_reduced(arch)
    rec = dryrun.cell_record(arch, "cell", False, cfg=cfg,
                             shape=ShapeSpec("cell", SEQ, BATCH, "train"),
                             mesh_shape=(1, 1), verbose=False)
    assert rec["dtype"] == "bfloat16" and "error" not in rec
    assert rec["peaks"]["peak_flops"] == hlo_analysis.PEAK_FLOPS[
        torch.bfloat16]
    shape = (BATCH, SEQ, SEQ, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim, True)
    n = cfg.n_layers
    k = rec["kernels"]
    assert {name: v["calls"] for name, v in k.items()} == {
        "flash_attention": 2 * n, "flash_attention_bwd": n}
    # the forward and the group checkpoint's recompute, each with the
    # rows' log-sum-exp; the backward once
    assert (k["flash_attention"]["flops"], k["flash_attention"]["bytes"]) \
        == tuple(2 * n * x for x in FA.flash_cost(*shape, 2, True))
    assert (k["flash_attention_bwd"]["flops"],
            k["flash_attention_bwd"]["bytes"]) == tuple(
        n * x for x in FA.flash_bwd_cost(*shape, 2))


def test_perf_probe_attributes_every_count_to_the_port_functions():
    from repro_torch.launch import perf_probe
    cfg = get_reduced("qwen2-vl-2b")
    fn, args, _ = dryrun.build_lowerable(
        "qwen2-vl-2b", "cell", multi_pod=False, cfg=cfg,
        shape=ShapeSpec("cell", SEQ, BATCH, "train"), mesh_shape=(1, 2),
        dtype=torch.float32)
    att = perf_probe.attribute(fn, args)
    cp = att["pass"]
    assert sum(att["flops"].values()) == sum(c.flops
                                             for c in cp.costs.values())
    assert sum(att["bytes"].values()) == sum(c.bytes
                                             for c in cp.costs.values())
    assert sum(att["colls"].values()) == sum(c.total_coll_bytes
                                             for c in cp.costs.values())
    tags = set(att["flops"])
    assert {"models/layers/ffn.apply_ffn",
            "models/layers/ffn.apply_ffn (bwd)"} <= tags
    assert "?" not in tags and not any(t.startswith("backward:")
                                       for t in tags)
    assert ("flash_attention_bwd",
            "models/layers/attention.attention_heads (bwd)") in att["bytes"]


def main():
    """Print each reduced cell's HBM bytes outside the kernels by op kind
    on (1, 1): the reference's (JAX ``hlo_costs.analyze``) beside the
    port's cost pass (PERF.md section 6)."""
    torch.set_num_threads(1)
    for arch in REDUCED:
        for kind in ("train", "prefill"):
            _, ref = _jax_outside_kernels(arch, kind)
            rec = _port_cell(arch, kind, (1, 1))
            port = {k: v for k, v in rec["bytes_by_op"].items()
                    if k not in rec["kernels"]}
            print(f"{arch} {kind}: reference "
                  f"{ {k: int(v) for k, v in sorted(ref.items()) if v} } "
                  f"(sum {int(sum(ref.values()))}); port {port} "
                  f"(sum {sum(port.values())})")


if __name__ == "__main__":
    main()
