"""How far a seeded RWKV-6's gradients move when only the wkv's rounding
moves: the whole model's gradients with the plain wkv in f32 (chunked,
and stepwise at chunk 1) against the same model with the wkv in f64.
rwkv6-1.6b's config with d_model, depth and vocabulary cut as asked
(d_ff in proportion), weights from ``factory.init_params(0, ...)``,
batch 2 x 128 tokens of ``make_batch_np`` (seed 1234), on the CPU:

    PYTHONPATH=src python3 scripts/rwkv_grad_sensitivity.py 512 24 4096

Prints the distance (the norm of the difference over the gradient's
norm), the leaves that carry most of it, and by layer the distance and
the gradient's norm, which shows where the gradient grows.  Keep the
shapes small here: d_model 2048 at 2 layers takes ~3 GB and ~40 s.
"""
import argparse
import collections
import dataclasses
import time

import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.kernels.wkv6 import kernel as W
from repro_torch.models import factory
from repro_torch.models.layers import rwkv6 as rwkv_layers
from repro_torch.train import train_step as TS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("d_model", type=int)
    ap.add_argument("n_layers", type=int)
    ap.add_argument("vocab", type=int)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    base = get_config("rwkv6-1.6b")
    cfg = dataclasses.replace(
        base, d_model=args.d_model, n_layers=args.n_layers,
        vocab_size=args.vocab,
        d_ff=base.d_ff * args.d_model // base.d_model // 32 * 32)
    model = factory.init_params(0, cfg, device="cpu").requires_grad_(True)
    batch = to_device(make_batch_np(cfg, ShapeSpec("x", 128, 2, "train"),
                                    1234, 10_000), torch.device("cpu"))
    print(f"rwkv6-1.6b cut to d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; batch 2 x 128")

    def f64(*a, chunk=64):
        return tuple(x.float() for x in W.wkv6_plain(
            *(t.double() for t in a), chunk=chunk))

    def stepwise(*a, chunk=64):
        return W.wkv6_plain(*a, chunk=1)

    def grads(mixer):
        rwkv_layers.wkv6 = mixer
        try:
            return TS._grads(model, batch, cfg)
        finally:
            rwkv_layers.wkv6 = W.wkv6

    t = time.perf_counter()
    loss_w, _, want = grads(f64)
    print(f"loss with the wkv in f64 {loss_w.item():.6f} "
          f"({time.perf_counter() - t:.1f} s)")
    for label, mixer in (("f32, chunks of 64", W.wkv6_plain),
                         ("f32, stepwise (chunk 1)", stepwise)):
        loss, _, got = grads(mixer)
        num = den = 0.0
        by_layer = collections.defaultdict(lambda: [0.0, 0.0])
        leaves = []
        for name, w in want.items():
            d = got[name].double() - w.double()
            a, b = float((d * d).sum()), float((w.double() ** 2).sum())
            num, den = num + a, den + b
            parts = name.split(".")
            layer = parts[2] if parts[0] == "groups" else parts[0]
            by_layer[layer][0] += a
            by_layer[layer][1] += b
            leaves.append((a, b, name))
        print(f"{label}: loss {loss.item():.6f}; distance "
              f"{(num / den) ** 0.5:.4e} of the gradient's norm "
              f"{den ** 0.5:.4e}")
        for a, b, name in sorted(leaves, reverse=True)[:5]:
            print(f"  {name}: {a / num:.3f} of the difference's square, "
                  f"{b / den:.3f} of the gradient's, distance "
                  f"{(a / b) ** 0.5 if b else 0.0:.3e}")
        print("  by layer (distance / norm): " + " ".join(
            f"{k} {(v[0] / v[1]) ** 0.5:.1e}/{v[1] ** 0.5:.1e}"
            for k, v in by_layer.items()))


if __name__ == "__main__":
    main()
