"""PyTorch + CUDA port of the QLC system for one NVIDIA H100.

Imports torch and numpy only; the JAX package ``repro`` is the reference
it is held against in the tests. Subpackages keep the reference's module
names (``quant.e4m3``, ``core.codec``, ``kernels.ops``, ...).
"""
