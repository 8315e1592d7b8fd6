"""PyTorch/CUDA port of the F-BFQ serving stack.

Mirrors ``repro``'s module layout (configs, core, kernels, models,
serving, launch) so each module has a counterpart there. The port imports
``torch`` and ``numpy`` only; the JAX package is its numerical reference
in the tests. Every packed matmul, in any of the eight weight formats,
runs through a hand-written CUDA kernel (``csrc/bfp_matmul.cu``) on the
GPU, and through its plain PyTorch version on CPU tensors.
"""
