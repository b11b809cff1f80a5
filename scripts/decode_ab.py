"""Phase d of ``chip_smoke.py`` (rwkv6-1.6b served at full width through
``factory.generate``: batch 8, prompt 512) run from each checkout given,
in turn, each in a fresh process on the first card: the decode step's
milliseconds inside ``generate`` (generate less its prefill) and timed
alone, as (median, min, max) over the phase's windows.  To compare two
commits on one card, give them as parent, change, change, parent:

  python3 scripts/decode_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each checkout runs its own ``chip_smoke.phase_rwkv_full`` against its
own ``src/``; the card's name and power limit are printed first.
"""
import json
import os
import subprocess
import sys

CHILD = r"""
import importlib.util, json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))
spec = importlib.util.spec_from_file_location(
    "smoke", os.path.join(root, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.kernels.sm_issue import kernel as K
from repro_torch.kernels.wkv6 import kernel as W
assert W.__file__.startswith(root), W.__file__
fr = smoke.phase_rwkv_full(torch, W, K)
per = 1e3 / (smoke.RWKV_NEW - 1)
print(json.dumps({k: [x * per for x in fr["times"][k]]
                  for k in ("generate - prefill", "decode")}))
"""


def main(dirs) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for d in dirs:
        out = subprocess.run([sys.executable, "-c", CHILD, d],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        t = json.loads(out.stdout.strip().splitlines()[-1])
        inside, alone = t["generate - prefill"], t["decode"]
        print(f"[decode_ab] {os.path.basename(os.path.abspath(d))}: decode "
              f"inside generate {inside[0]:.3f} ms a step ({inside[1]:.3f}"
              f"-{inside[2]:.3f}); alone {alone[0]:.3f} ms ({alone[1]:.3f}"
              f"-{alone[2]:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
