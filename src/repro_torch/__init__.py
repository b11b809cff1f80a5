"""PyTorch port of the cycle-accurate GPU simulator in ``repro``.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names and is held bit-exact against it.  It imports neither
``jax`` nor ``repro``.
"""
