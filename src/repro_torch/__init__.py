"""PyTorch + CUDA port of the DoRA system for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference this package is held against;
this package imports ``torch`` and never ``jax`` or ``repro``. Its layout
mirrors the reference so each module's counterpart is easy to find:
``core`` (config, numerics, dispatch, adapter), ``kernels`` (hand-written
CUDA kernels with their plain PyTorch versions), ``models`` (dense LM),
``launch`` (serving steps and the ``generate`` driver) and ``bridge``
(weights carried over from the reference's numpy pytrees).
"""
