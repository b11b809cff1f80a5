"""Write tests/golden/torch_port_moe_reduced.json from the JAX package:
the reduced arctic-480b and deepseek-v3-671b with seeded weights
(``repro_torch.convert.seeded_lm_params``, constant leaves jittered), their
prefill and first decode logits, greedy tokens, and the training loss of
one seeded batch.  ``chip_smoke.py`` holds the card to it (phases i and
y); tests/test_torch_moe_lm.py holds the file to the JAX package and the
port on the CPU.  Needs JAX; run from the repository's root:

    PYTHONPATH=src python scripts/moe_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

from test_torch_moe_lm import regen  # noqa: E402

if __name__ == "__main__":
    regen()
