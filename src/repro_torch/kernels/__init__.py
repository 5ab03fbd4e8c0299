"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Each wrapper launches its kernel for CUDA tensors and uses the plain
PyTorch version in ``ref.py`` only for CPU tensors.  The CUDA sources live
in ``repro_torch/csrc`` and are built into one shared library at first use
(``kernels/build.py``).
"""
