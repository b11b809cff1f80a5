"""Multi-pod dry run: every (arch × shape × mesh) cell traced on fake
tensors, with no card; the port's ``repro.launch.dryrun``.

For each cell this runs the port's own train step, prefill or decode
(``make_train_step``, ``factory.prefill``, ``factory.decode`` under the
production ctx) on fake tensors (``torch._subclasses.fake_tensor``),
each mesh position on a device of its own, under the cost pass
(``launch/hlo_costs.py``), and writes one JSON record under
``experiments/dryrun_torch/`` with

  · per-device argument, output, temporary and peak bytes (proves it fits)
  · per-device FLOPs and HBM bytes, the kernels' by their own formulas
  · collective bytes by helper and by link (NVLink within a host of 8,
    the network between hosts)
  · the three roofline terms on the H100 (``launch/hlo_analysis.py``)

The single controller is not symmetric (a row's first position gathers
and combines), so each ``*_per_dev`` figure is the busiest device's,
named under ``busiest`` by mesh position.  Mesh position i stands for
card i; its fake tensors lie on ``cpu:i``, since autograd on a fake
CUDA tensor needs the CUDA device guard (a CPU-only build has none, and
a card's build has one only for the cards it sees).  The kernels' fake
branch takes a fake tensor wherever it lies (``kernels/costs.py``).
Nothing is compiled: ``compile_s`` is None and ``lower_s`` is the trace.
Cells run in bf16 unless ``dtype=`` says otherwise, the reference's
default: parameters, activations and the kernels' operands (K3' and its
backward at bf16 bytes), the moments at ``_opt_config``'s dtype.

Usage:
  python -m repro_torch.launch.dryrun --arch codeqwen1.5-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes]

Each cell runs on one host thread; to trace several at once, start one
process a cell from the shell (``README.md`` shows one way).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from functools import partial

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import hlo_costs
from repro_torch.launch.mesh import (make_ctx, make_production_mesh,
                                     make_train_mesh)
from repro_torch.models import factory, sharded, whisper
from repro_torch.parallelism import sharding as shd
from repro_torch.train.optimizer import OptConfig, moment_dtype
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          placed_train_state)

OUT_DIR = os.path.join(os.path.dirname(__file__),
                       "../../../experiments/dryrun_torch")


def _opt_config(cfg) -> OptConfig:
    big = cfg.param_count() > 1e11
    return OptConfig(moment_dtype="bfloat16" if big else "float32")


def fake_devices(n: int) -> list:
    """Mesh positions 0 … n-1, each a device of its own (``cpu:i`` for
    card i; see the module's docstring)."""
    return [torch.device("cpu", i) for i in range(n)]


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is not None:
        n = int(np.prod(mesh_shape))
        return (make_train_mesh(mesh_shape, devices=fake_devices(n)),
                "x".join(map(str, mesh_shape)))
    return (make_production_mesh(multi_pod=multi_pod,
                                 devices=fake_devices(512 if multi_pod
                                                      else 256)),
            "2x16x16" if multi_pod else "16x16")


def _batch(cfg, b: int, s: int, dtype, device) -> dict:
    """The reference's ``batch_specs`` as zero tensors (``decode_batch_specs``
    for s = None)."""
    def ids(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    def emb(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if s is None:
        if cfg.frontend == "vision":
            return {"embeds": emb(b, 1, cfg.d_model)}
        return {"tokens": ids(b, 1)}
    if cfg.enc_dec:
        return {"frames": emb(b, whisper.ENC_LEN, cfg.d_model),
                "tokens": ids(b, s), "labels": ids(b, s)}
    if cfg.frontend == "vision":
        return {"embeds": emb(b, s, cfg.d_model), "labels": ids(b, s)}
    return {"tokens": ids(b, s), "labels": ids(b, s)}


def _in_mode(mode, fn):
    def run(*args):
        with mode:
            return fn(*args)
    return run


def _unsharded(cfg, shape, dtype, mode):
    """(fn, args) of the cell without a mesh, on fake card 0: the model
    made from zeros of ``param_shapes`` (the path ``chip_smoke.py`` holds
    against a live step)."""
    b, s = shape.global_batch, shape.seq_len
    home = fake_devices(1)[0]
    with mode:
        model = factory.from_state_dict(cfg, {
            n: torch.zeros(sh, dtype=dtype, device=home)
            for n, sh in factory.param_shapes(cfg, dtype, max_seq=s).items()})
        if shape.kind == "train":
            opt_cfg = _opt_config(cfg)
            return (make_train_step(cfg, opt_cfg),
                    (init_train_state(model, cfg, opt_cfg),
                     _batch(cfg, b, s, dtype, home)))
        if shape.kind == "prefill":
            return (partial(factory.prefill, cfg=cfg, max_len=s),
                    (model, _batch(cfg, b, s, dtype, home)))
        cache = factory.init_cache(cfg, b, s, dtype, device=home)
        return (partial(factory.decode, cfg=cfg),
                (model, cache, _batch(cfg, b, None, dtype, home)))


def build_lowerable(arch: str, shape_name: str, *, multi_pod: bool,
                    dtype=torch.bfloat16, mesh_shape=None, cfg=None,
                    shape=None):
    """Returns (fn, args, meta): ``fn(*args)`` is the cell's step on fake
    tensors, to run under a cost pass.  ``mesh_shape`` replaces the
    production mesh (() for none: the unsharded step on one card),
    ``cfg`` and ``shape`` the named config and shape (the tests' reduced
    cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if not cfg.supports(shape):
        return None, None, {"skipped": True,
                            "reason": cfg.skipped_cells()[0][1]}
    mode = FakeTensorMode()
    if mesh_shape == ():
        fn, args = _unsharded(cfg, shape, dtype, mode)
        return _in_mode(mode, fn), args, {
            "skipped": False, "n_chips": 1, "mesh": "unsharded",
            "kind": shape.kind}
    mesh, label = _mesh(multi_pod, mesh_shape)
    ctx = make_ctx(mesh)
    home = mesh.devices.flat[0]
    b, s = shape.global_batch, shape.seq_len
    shapes = factory.param_shapes(cfg, dtype, max_seq=s)
    pspecs = shd.param_pspecs(shapes, cfg, ctx)
    with mode:
        if shape.kind == "train":
            opt_cfg = _opt_config(cfg)
            state = placed_train_state(
                shd.zeros_tree(shapes, pspecs, mesh, dtype, leaves=True),
                cfg, opt_cfg, ctx)
            fn = make_train_step(cfg, opt_cfg, ctx)
            args = (state, _batch(cfg, b, s, dtype, home))
        else:
            pm = sharded.PlacedModel(
                shd.zeros_tree(shapes, pspecs, mesh, dtype), ctx)
            if shape.kind == "prefill":
                fn = partial(factory.prefill, cfg=cfg, ctx=ctx, max_len=s)
                args = (pm, _batch(cfg, b, s, dtype, home))
            else:                                   # decode / long_decode
                cache = factory.init_cache(cfg, b, s, dtype, ctx=ctx)
                fn = partial(factory.decode, cfg=cfg, ctx=ctx)
                args = (pm, cache, _batch(cfg, b, None, dtype, home))
    meta = {"skipped": False, "n_chips": mesh.devices.size, "mesh": label,
            "kind": shape.kind}
    return _in_mode(mode, fn), args, meta


def state_bytes(cfg, ctx, *, train: bool, dtype=torch.float32,
                max_seq: int = 4096) -> np.ndarray:
    """Each mesh position's bytes of parameters (and, for ``train``, of
    the two moments at ``_opt_config``'s dtype), from shapes and specs
    alone: no tensor is made.  A position stores its block of every leaf
    (a stacked layer only where its block of the layer axis holds it)."""
    mesh = ctx.mesh
    n = mesh.devices.size
    coords = dict(zip(mesh.axis_names,
                      np.indices(mesh.devices.shape).reshape(
                          len(mesh.axis_names), n)))

    def block(entry):
        axes = () if entry is None else (entry if isinstance(entry, tuple)
                                         else (entry,))
        k, nb = np.zeros(n, dtype=np.int64), 1
        for a in axes:
            k, nb = k * mesh.shape[a] + coords[a], nb * mesh.shape[a]
        return k, nb

    def leaf_bytes(specs, itemsize):
        out = np.zeros(n, dtype=np.int64)
        for name, shape in shapes.items():
            entries = list(specs[name])
            held = np.ones(n, dtype=bool)
            if layers[name] is not None:
                i, nl = layers[name]
                k, nb = block(entries.pop(0))
                held &= (i // (nl // nb)) == k
            numel = int(np.prod(shape))
            for entry in entries:
                numel //= block(entry)[1]
            out += held * numel * itemsize
        return out

    shapes = factory.param_shapes(cfg, dtype, max_seq=max_seq)
    layers = shd.leaf_layers(shapes)
    pspecs = shd.param_pspecs(shapes, cfg, ctx)
    total = leaf_bytes(pspecs, torch.empty((), dtype=dtype).element_size())
    if train:
        mspecs = shd.moments_pspecs(pspecs, shapes, ctx)
        size = torch.empty((), dtype=moment_dtype(_opt_config(cfg))
                           ).element_size()
        total = total + 2 * leaf_bytes(mspecs, size)
    return total


def _device_terms(costs: dict, n_chips: int, model_flops: float,
                  dtype) -> dict:
    """{device: its roofline terms} of a cost pass's counts."""
    out = {}
    for dev, c in costs.items():
        out[dev] = hlo.roofline_terms(
            c.flops, c.bytes, c.total_coll_bytes, n_chips, model_flops,
            inter_host_bytes=c.link_bytes["inter"], dtype=dtype)
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, dtype=torch.bfloat16, **build) -> dict:
    cfg = build.get("cfg") or get_config(arch)
    shape = build.get("shape") or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "dtype": str(dtype).replace("torch.", "")}
    fn, args, meta = build_lowerable(arch, shape_name, multi_pod=multi_pod,
                                     dtype=dtype, **build)
    rec.update(meta)
    if meta.get("skipped"):
        if verbose:
            print(f"[dryrun] SKIP {arch} × {shape_name}: {meta['reason']}")
        return rec
    n_chips = meta["n_chips"]
    t0 = time.time()
    _, cp = hlo_costs.analyze(fn, *args)
    t1 = time.time()
    del fn, args
    model_flops = cfg.model_flops(shape)
    # the mesh's devices (a host tensor, such as a step's scalars, lies on
    # the index-less "cpu")
    costs = {d: c for d, c in cp.costs.items() if d.index is not None}
    memory = {d: m for d, m in cp.memory.items() if d.index is not None}
    terms = _device_terms(costs, n_chips, model_flops, dtype)

    def busiest(value, table):
        dev = max(table, key=lambda d: value(table[d]))
        return dev, value(table[dev])

    dev_b, _ = busiest(lambda t: t["step_bound_s"], terms)
    c = costs[dev_b]
    fields = {
        "arg_bytes_per_dev": (lambda m: m.arg, memory),
        "temp_bytes_per_dev": (lambda m: m.temp, memory),
        "output_bytes_per_dev": (lambda m: m.out, memory),
        "peak_bytes_per_dev": (lambda m: m.peak, memory),
        "hlo_flops_per_dev": (lambda c: c.flops, costs),
        "hlo_bytes_per_dev": (lambda c: c.bytes, costs),
        "collective_bytes_per_dev": (lambda c: c.total_coll_bytes, costs),
    }
    rec["busiest"] = {"step_bound_s": dev_b.index}
    for key, (value, table) in fields.items():
        dev, v = busiest(value, table)
        rec[key] = int(v) if "flops" not in key else float(v)
        rec["busiest"][key] = dev.index
    flops_global = float(sum(x.flops for x in costs.values()))
    rec.update({
        "lower_s": round(t1 - t0, 2),
        "compile_s": None,
        "collectives": {k: {"bytes": c.coll_bytes[k],
                            "count": c.coll_count[k]}
                        for k in sorted(c.coll_bytes)},
        "link_bytes": dict(c.link_bytes),
        "bytes_by_op": {k: round(v) for k, v in sorted(
            c.bytes_by_op.items(), key=lambda kv: -kv[1])},
        "kernels": {k: dict(v) for k, v in sorted(cp.kernels.items())},
        **terms[dev_b],
        "hlo_flops_global": flops_global,
        "useful_flops_ratio": (model_flops / flops_global if flops_global
                               else 0.0),
        "peaks": hlo.peaks(dtype),
    })
    if verbose:
        print(f"[dryrun] OK {arch} × {shape_name} × {rec['mesh']}  "
              f"trace={rec['lower_s']}s  "
              f"peak/dev={rec['peak_bytes_per_dev']/2**30:.2f}GiB  "
              f"terms(c/m/x)=({rec['compute_term_s']:.3e},"
              f"{rec['memory_term_s']:.3e},"
              f"{rec['collective_term_s']:.3e})s  "
              f"dom={rec['dominant']}  "
              f"roofline={rec['roofline_fraction']:.3f}", flush=True)
    return rec


def save_record(rec: dict, out_dir: str = OUT_DIR):
    os.makedirs(out_dir, exist_ok=True)
    mesh = rec["mesh"].replace("x", "_")
    name = f"{rec['arch']}__{rec['shape']}__{mesh}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def cell_record(arch: str, shape_name: str, multi_pod: bool, **kw) -> dict:
    """``run_cell``'s record, or the reference's error record where the
    cell raised (a kernel's limit, such as a head size without a
    kernel).  bf16 by default, as ``run_cell``."""
    try:
        return run_cell(arch, shape_name, multi_pod=multi_pod, **kw)
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "dtype": str(kw.get("dtype", torch.bfloat16)).replace(
                    "torch.", ""),
                "error": f"{type(e).__name__}: {e}"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    cells = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            rec = cell_record(arch, shape, mp)
            if "error" in rec:
                failures.append(rec)
            save_record(rec, args.out)
            gc.collect()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES")
        for f in failures:
            print("  ", f["arch"], f["shape"], f["mesh"], f["error"][:200])
        raise SystemExit(1)
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
