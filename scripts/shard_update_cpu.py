"""How far the sharded train step's parameter updates sit from the
unsharded step's, leaf by leaf, on the CPU: the reading behind
chip_smoke.py's SHARD_UPDATE_TOL.  Run from the repository root:

    PYTHONPATH=src python scripts/shard_update_cpu.py [--seq 64 256]

Reduced qwen2-vl-2b, batch 8 x SEQ, weights drawn from seed 0 with their
constant leaves jittered as phase z draws them, AdamW at phase z's
TRAIN_OPT, 3 steps on each of phase z's ('data', 'model') meshes of the
CPU ((4, 1) and (2, 2)) and 3 unsharded.  Prints, per mesh, for the worst
leaves and the median one, each leaf's change sharded against unsharded
in L2 over the unsharded change, and the leaf's gradient RMS (from
AdamW's second moment) over the whole model's.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.configs import ShapeSpec, get_reduced  # noqa: E402
from repro_torch.data.pipeline import make_batch_np, to_device  # noqa: E402
from repro_torch.launch.mesh import make_ctx, make_train_mesh  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402


def run(cfg, shape, kw):
    """(initial parameters, final plain state) of TRAIN_STEPS steps."""
    opt_cfg = OptConfig(**CS.TRAIN_OPT)
    model = factory.init_params(0, cfg, device="cpu")
    CS.jitter_constants(torch, model, 1)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    state = TS.init_train_state(model, cfg, opt_cfg, **kw)
    step_fn = TS.make_train_step(cfg, opt_cfg, **kw)
    for step in range(CS.TRAIN_STEPS):
        state, _ = step_fn(state, to_device(make_batch_np(
            cfg, shape, CS.TRAIN_DATA_SEED, step), "cpu"))
    return init, TS.plain_state(state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, nargs="+", default=[64, 256])
    args = ap.parse_args()
    cfg = get_reduced(CS.SHARD_ARCH)
    for seq in args.seq:
        shape = ShapeSpec("u", seq, CS.SHARD_BATCH, "train")
        init, flat = run(cfg, shape, {})
        p_un = flat["params"].state_dict()
        v = flat["opt"]["v"]
        rms_all = (sum(float(t.sum()) for t in v.values())
                   / sum(t.numel() for t in v.values())) ** 0.5
        for mesh in CS.SHARD_MESHES:
            ctx = make_ctx(make_train_mesh(mesh, device="cpu"))
            _, sharded = run(cfg, shape, {"ctx": ctx})
            p_sh = sharded["params"].state_dict()
            rows = []
            for n, t in p_un.items():
                moved = float((t - init[n]).norm())
                apart = float((p_sh[n] - t).norm())
                rows.append((apart / moved if moved else 0.0, n,
                             float(v[n].mean()) ** 0.5 / rms_all))
            rows.sort(reverse=True)
            print(f"reduced {CS.SHARD_ARCH}, batch {CS.SHARD_BATCH} x {seq}, "
                  f"mesh {mesh}, AdamW {CS.TRAIN_OPT}: each leaf's change "
                  f"in L2 over the unsharded change (gradient RMS over the "
                  f"model's):")
            for x, n, g in rows[:4] + [rows[len(rows) // 2]]:
                print(f"  {n:32s} {x:.2e} ({g:.2f})")


if __name__ == "__main__":
    main()
