"""PyTorch port of the JAX package ``repro``: the cycle-accurate GPU
simulator and, from the LM stack, RWKV-6 serving.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names.  The simulator is held bit-exact against it, the LM
path within stated float tolerances.  It imports neither ``jax`` nor
``repro``.
"""
