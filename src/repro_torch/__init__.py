"""PyTorch/CUDA port of the ``repro`` analytics engine.

The package mirrors ``repro``'s layout module for module, so each piece has
an obvious counterpart in the JAX reference.  It imports ``torch`` and
numpy only.  Device code runs on an NVIDIA Hopper card: plain tensor work
is PyTorch, and the five hot operators (range filter, hash probe, group-by
sum, join run expansion, top-k selection) are hand-written CUDA kernels in
``csrc/``.
"""
