"""chip_smoke.py's phase z on four distinct cards, beside the same phase
with every position on the first card.  Run from the repository root on
a machine with four CUDA cards:

    PYTHONPATH=src python3 scripts/shard_probes.py

qwen2-vl-2b whole, batch 8 x 512, trained by the sharded step on phase
z's (4, 1) and (2, 2) ('data', 'model') meshes of cuda:0..3
(``phase_shard_train(devices=...)``: on each mesh the sharded steps
twice, then the unsharded steps on cuda:0; on (2, 2) each card stores
only its blocks of the parameters the model axis splits), then the same
on meshes that repeat cuda:0.  Prints the cards' names and power limits
first, then each run's lines as phase z prints them (step walls,
tokens/s, each card's peak memory, K3' launches, the profiled steps'
idle share) and holds each mesh as phase z holds it.  Holds the
four-card metrics to the repeated card's, mesh by mesh, within phase z's
limits and exits non-zero if a check fails.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG)
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402

N_CARDS = 4


def main():
    if torch.cuda.device_count() < N_CARDS:
        print(f"shard_probes: needs {N_CARDS} CUDA cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout, flush=True)
    card = CS.card_line()
    FA.build()
    FA.build_bwd()
    cards = [torch.device("cuda", i) for i in range(N_CARDS)]
    for c in cards:             # the allocator's stats need a context
        torch.zeros(1, device=c)
    runs = {}
    for name, devices in (("four cards", cards),
                          ("one card repeated", [cards[0]] * N_CARDS)):
        print(f"[shard probe] {name}", flush=True)
        runs[name] = CS.phase_shard_train(torch, FA, devices=devices)
        CS.report_shard_train(runs[name], card, name)
    for mesh in CS.SHARD_MESHES:
        four, one = (runs[n]["runs"][mesh, "sharded"]["rows"] for n in runs)
        rel = {k: max(abs(a[k] - b[k]) / (abs(b[k]) or 1.0)
                      for a, b in zip(four, one))
               for k in ("loss", "ce", "grad_norm")}
        print(f"[shard probe] {mesh}: four cards against one card "
              f"repeated: worst relative difference {rel}", flush=True)
        CS.check(max(rel["loss"], rel["ce"]) <= CS.MOE_TRAIN_METRIC_TOL
                 and rel["grad_norm"] <= CS.MOE_TRAIN_GRAD_TOL,
                 f"{mesh}: four cards depart from one card repeated: {rel}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
