"""The port's kernels and their plain PyTorch versions.

Each kernel module (fused_rrdb, fused_tail3, fused_tail) keeps, beside
its wrapper, the plain version of the same function, a launch counter
(``<wrapper>.launches``) and the weight layout the kernel reads. The
CUDA sources are in ``csrc/``; ``_build`` compiles them with one nvcc
call at first use.
"""
