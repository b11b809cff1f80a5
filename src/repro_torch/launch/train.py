"""Training launcher: data pipeline + train step + checkpoint/restart, the
JAX package's ``launch/train.py``.

  python -m repro_torch.launch.train --device cpu             # reduced codeqwen
  python -m repro_torch.launch.train --arch rwkv6-1.6b --full --steps 4 \\
      --ckpt-every 4 --ckpt /path/to/dir
  python -m repro_torch.launch.train --arch deepseek-v3-671b --device cpu
  python -m repro_torch.launch.train --arch whisper-base --full --seq 448

``--arch`` takes every family: RWKV-6, the dense GQA models,
arctic-480b and deepseek-v3-671b, jamba-v0.1-52b (Mamba and attention
periods) and whisper-base (its batches carry 1,500 frames beside the
decoder tokens); ``--full`` trains the published config, which fits one
card for rwkv6-1.6b and whisper-base; at full width one MoE layer's or
jamba period's training state (~16 bytes a parameter) does not, and waits
for the sharded step.

Runs on the CUDA device unless ``--device`` names another.  On restart
with the same ``--ckpt`` it resumes from the latest checkpoint (written by
either package: the file format is the reference's) and replays the
deterministic pipeline, so the run continues bit for bit.  Weights are
random, from a ``torch.Generator`` seeded with 0 (not the reference's
draws).  ``--mesh single|multi`` refuses: the sharded step's data axes
and the model axis that splits heads (the ``rwkv`` and ``std:dense``
families) are ported (``launch/mesh.py:make_ctx``, ``make_train_step(cfg,
opt, ctx)``), but both production meshes have a model axis of 16, and
the rest of it (sequence-parallel attention for heads that 16 does not
divide, Mamba, MLA, expert placement, Whisper) waits for slice 11d.5b.2.
Prints the reference's lines.
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
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production mesh has a model axis of "
            "16; the sharded step's data axes are ported, and so is the "
            "model axis where it splits heads (the rwkv and std:dense "
            "families: make_ctx and make_train_step(cfg, opt_cfg, ctx)), "
            "but the production configs include the families that wait for "
            "ROADMAP slice 11d.5b.2 (sequence-parallel attention, Mamba, "
            "MLA, expert placement, Whisper)")
    # deterministic cuBLAS, read when CUDA starts (train_step.deterministic)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=5,
                        total_steps=args.steps)
    state = init_train_state(0, cfg, opt_cfg, device=device)
    start = 0
    if args.ckpt:
        ls = latest_step(args.ckpt)
        if ls is not None:
            state = restore(args.ckpt, ls, state, cfg)
            start = ls
            print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg)
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
