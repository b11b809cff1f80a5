"""Write tests/golden/torch_port_hybrid_reduced.json from the JAX package:
the reduced jamba-v0.1-52b and whisper-base with seeded weights
(``repro_torch.convert.seeded_lm_params``, constant leaves jittered), their
prefill and first decode logits, greedy tokens, and the training loss of
one seeded batch (Whisper's frames are drawn from a numpy seed the file
names).  ``chip_smoke.py`` holds the card to it (phases j and y);
tests/test_torch_jamba_lm.py and tests/test_torch_whisper.py hold the
file to the JAX package and the port on the CPU.  Needs JAX; run from the
repository's root:

    PYTHONPATH=src python scripts/hybrid_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

from _hybrid import regen  # noqa: E402

if __name__ == "__main__":
    regen()
