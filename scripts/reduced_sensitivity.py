"""How far phase y's reduced training runs move when only rounding moves:
each reduced model of chip_smoke.py's SHARD_Y_TP_ARCHS trained unsharded
on the CPU for 2 x TRAIN_STEPS steps from the hybrid golden's seeds, as
phase y trains it (TRAIN_OPT, batches of TRAIN_DATA_SEED), against the
same steps from weights each multiplied by 1 + eps N(0, 1), an f32
rounding's worth at eps 1e-7.  Run from the repository root:

    PYTHONPATH=src python3 scripts/reduced_sensitivity.py [--eps 1e-7 1e-6]

Prints, per model and eps, the worst relative move over the steps of the
loss and of the gradient's norm, and each step's move of the gradient's
norm: the reading behind chip_smoke.py's RWKV_Y_GRAD_TOL.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.configs import ShapeSpec, get_reduced  # noqa: E402
from repro_torch.convert import (jitter_constant_leaves,  # noqa: E402
                                 lm_params_to_torch, seeded_lm_params)
from repro_torch.data.pipeline import make_batch_np, to_device  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402


def run(cfg, state_dict, shape):
    """Per step (loss, grad_norm) of 2 x TRAIN_STEPS unsharded steps from
    a copy of ``state_dict`` (the step updates its model in place)."""
    opt = OptConfig(**CS.TRAIN_OPT)
    state = TS.init_train_state(factory.from_state_dict(
        cfg, {n: t.clone() for n, t in state_dict.items()}), cfg, opt)
    step_fn = TS.make_train_step(cfg, opt)
    rows = []
    for step in range(2 * CS.TRAIN_STEPS):
        state, m = step_fn(state, to_device(make_batch_np(
            cfg, shape, CS.TRAIN_DATA_SEED, step), "cpu"))
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7, 1e-6])
    ap.add_argument("--draws", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    with open(os.path.join(CS.GOLDEN, CS.HYBRID_GOLDEN)) as f:
        golden = json.load(f)
    b, s = golden["train_shape"]
    shape = ShapeSpec("y", s, b, "train")
    for arch in CS.SHARD_Y_TP_ARCHS:
        cfg = get_reduced(arch)
        weights = lm_params_to_torch(jitter_constant_leaves(
            seeded_lm_params(cfg, golden["weight_seed"],
                             max_seq=golden["max_seq"]),
            golden["jitter_seed"]), cfg, "cpu")
        base = run(cfg, weights, shape)
        for eps in args.eps:
            moves = []
            for draw in range(1, args.draws + 1):
                gen = torch.Generator().manual_seed(draw)
                rows = run(cfg, {n: t * (1 + eps * torch.randn(
                    t.shape, generator=gen)) for n, t in weights.items()},
                    shape)
                moves.append([(abs(lo / lb - 1), abs(g / gb - 1))
                              for (lo, g), (lb, gb) in zip(rows, base)])
            by_step = [max(m[i][1] for m in moves)
                       for i in range(len(base))]
            print(f"{arch} reduced, eps {eps:g} ({args.draws} draws): "
                  f"worst move loss "
                  f"{max(x for m in moves for x, _ in m):.2e}, grad_norm "
                  f"{max(by_step):.2e}; grad_norm by step "
                  + ", ".join(f"{x:.1e}" for x in by_step), flush=True)


if __name__ == "__main__":
    main()
