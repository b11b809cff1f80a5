"""Training launcher: data pipeline + train step + checkpoint/restart, the
JAX package's ``launch/train.py``.

  python -m repro_torch.launch.train --device cpu             # reduced codeqwen
  python -m repro_torch.launch.train --arch rwkv6-1.6b --full --steps 4 \\
      --ckpt-every 4 --ckpt /path/to/dir
  python -m repro_torch.launch.train --arch deepseek-v3-671b --device cpu
  python -m repro_torch.launch.train --arch whisper-base --full --seq 448
  python -m repro_torch.launch.train --arch qwen2-vl-2b --mesh single \
      --device cpu --steps 2

``--arch`` takes every family: RWKV-6, the dense GQA models,
arctic-480b and deepseek-v3-671b, jamba-v0.1-52b (Mamba and attention
periods) and whisper-base (its batches carry 1,500 frames beside the
decoder tokens); ``--full`` trains the published config, which fits one
card for rwkv6-1.6b and whisper-base; at full width one MoE layer's or
jamba period's training state (~16 bytes a parameter) does not, and
needs the sharded step over several cards (scripts/shard_probes.py).

Runs on the CUDA device unless ``--device`` names another.  On restart
with the same ``--ckpt`` it resumes from the latest checkpoint (written by
either package: the file format is the reference's) and replays the
deterministic pipeline, so the run continues bit for bit.  Weights are
random, from a ``torch.Generator`` seeded with 0 (not the reference's
draws).  ``--mesh single|multi`` trains by the sharded step on the
reference's production mesh, (16, 16) ('data', 'model') or (2, 16, 16)
('pod', 'data', 'model') (``launch/mesh.py:make_production_mesh``): its
first 256 or 512 CUDA cards, or the ``--device`` named at every position
(``--device cuda:0`` repeats one card, ``--device cpu`` runs here).  It
takes every config: the MoE layers' experts placed by ``ctx.ep_axes``,
MLA's heads and Mamba's d_inner split by the model axis.  Checkpoints are saved and restored through the sharded state, in the
unsharded file.  Prints the reference's lines.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.checkpointing.checkpoint import (AsyncSaver, latest_step,
                                                  restore)
from repro_torch.configs import ShapeSpec, get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.parallelism.ctx import NULL_CTX
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    # deterministic cuBLAS, read when CUDA starts (train_step.deterministic)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=5,
                        total_steps=args.steps)
    if args.mesh == "none":
        ctx = NULL_CTX
        device = resolve_device(args.device)
    else:
        ctx = make_ctx(make_production_mesh(multi_pod=args.mesh == "multi",
                                            device=args.device))
        device = ctx.mesh.devices.flat[0]
    step_fn = make_train_step(cfg, opt_cfg, ctx)
    state = init_train_state(0, cfg, opt_cfg, device=device, ctx=ctx)
    start = 0
    if args.ckpt:
        ls = latest_step(args.ckpt)
        if ls is not None:
            state = restore(args.ckpt, ls, state, cfg)
            start = ls
            print(f"[train] resumed from step {start}")
    saver = AsyncSaver()
    pipe = Pipeline(cfg, shape, DataConfig(), start_step=start,
                    device=device)
    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(pipe)
        state, metrics = step_fn(state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            saver.save_async(args.ckpt, step + 1, state, cfg)
    saver.wait()
    pipe.close()
    final = ("no step left to take" if metrics is None
             else f"final loss {float(metrics['loss']):.4f}")
    print(f"[train] done: {max(args.steps - start, 0)} steps, {final}")
    return state


if __name__ == "__main__":
    main()
