"""Batched serving: prefill a batch of prompts, decode with greedy
sampling, report tokens/s — the port's counterpart of
``examples/serve_decode.py``, through ``factory.generate``.

  python -m repro_torch.launch.serve_decode                 # reduced rwkv6-1.6b
  python -m repro_torch.launch.serve_decode --full --prompt-len 512
  python -m repro_torch.launch.serve_decode --arch minitron-8b --full
  python -m repro_torch.launch.serve_decode --arch minitron-8b --device cpu
  python -m repro_torch.launch.serve_decode --arch arctic-480b --device cpu
  python -m repro_torch.launch.serve_decode --arch jamba-v0.1-52b --device cpu

Runs on the CUDA device unless ``--device`` names another; ``--full``
takes the published configuration in place of the reduced one (f32
weights: 6.4 GB for rwkv6-1.6b, 30.9 GB for minitron-8b).  ``--arch``
takes the decoder families that serve token prompts: rwkv6-1.6b, the
dense GQA models (minitron-8b, qwen2-72b, codeqwen1.5-7b,
phi3-medium-14b, qwen2-vl-2b), the MoE models arctic-480b and
deepseek-v3-671b, and jamba-v0.1-52b.  The published MoE and jamba
configs do not fit one card (jamba's 32 layers are 52 B parameters,
~208 GB in f32; one of its four 8-layer periods at full width is 13.30 B
with the embedding and head, 53.2 GB): the chip smoke serves them at
full width cut in depth.  whisper-base, whose prefill needs audio
frames, is served through ``factory.prefill`` and ``decode`` (chip_smoke
phase w).
Weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import factory


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the reduced one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    params = factory.init_params(args.seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32, device=device)
    # warmup (library initialisation, the kernels' build)
    factory.generate(params, cfg, prompts, max_new=2)
    _sync(device)
    t0 = time.time()
    out = factory.generate(params, cfg, prompts, max_new=args.max_new)
    _sync(device)
    dt = time.time() - t0
    print(f"[{args.arch}] batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new}: {args.batch * args.max_new / dt:.1f} tok/s")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
